"""Hashing models: encoder trunks and hashing heads as ``nn.Module``s."""

from nlsh_tpu_torch.models.encoders import (  # noqa: F401
    MLPEncoder,
    SirenEncoder,
    get_encoder,
)
from nlsh_tpu_torch.models.hashings import (  # noqa: F401
    Categorical,
    MultivariateBernoulli,
    ProductQuantization,
    get_hashing,
)
