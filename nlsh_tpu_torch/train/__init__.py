"""Training layer: the trainer harness, the learner families and the
HNSW baseline (port of :mod:`nlsh_tpu.train`)."""

from nlsh_tpu_torch.train.base import Trainer, TrainState  # noqa: F401
from nlsh_tpu_torch.train.triplet import TripletTrainer, triplet_loss  # noqa: F401
from nlsh_tpu_torch.train.siamese import SiameseTrainer, contrastive_loss  # noqa: F401
from nlsh_tpu_torch.train.proposed import ProposedTrainer  # noqa: F401
from nlsh_tpu_torch.train.ae import AETrainer  # noqa: F401
from nlsh_tpu_torch.train.vqvae import VQVAETrainer  # noqa: F401
from nlsh_tpu_torch.train.multitable import MultiTableTrainer  # noqa: F401
from nlsh_tpu_torch.train.hnsw import HNSWBaseline  # noqa: F401

# reference-compatible aliases
AE = AETrainer
VQVAE = VQVAETrainer
