"""Ground-truth precompute CLI (port of :mod:`nlsh_tpu.cli.precompute`):

    python3 -m nlsh_tpu_torch.cli.precompute glove_100 [-k 100] [--device cuda]

The self-kNN of the training set (:func:`nlsh_tpu_torch.ops.knn.self_knn`,
exact f32 on ``--device``, default ``cuda``) is written with the
dataset's arrays to the ``.processed`` hdf5 file the datasets read:
``train``, ``train_knn``, ``test``, ``neighbors`` (+ ``distances``).
The source file's path comes from the environment (``NLSH_GLOVE_100_PATH``
and so on, or ``.env``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from nlsh_tpu_torch.ops.knn import self_knn
from nlsh_tpu_torch.train.base import resolve_device
from nlsh_tpu_torch.utils.env import get_env

DATA_PATH_KEYS = {
    "glove_25": "NLSH_GLOVE_25_PATH",
    "glove_50": "NLSH_GLOVE_50_PATH",
    "glove_100": "NLSH_GLOVE_100_PATH",
    "glove_200": "NLSH_GLOVE_200_PATH",
    "sift": "NLSH_SIFT_PATH",
}

# sq_euclidean ranks as the reference's sqrt-free L2
METRIC_BY_KEY = {
    "glove_25": "cosine",
    "glove_50": "cosine",
    "glove_100": "cosine",
    "glove_200": "cosine",
    "sift": "sq_euclidean",
}


def precompute(data_path: str, metric: str, k: int = 100,
               out_path: str | None = None, device="cuda") -> str:
    """Write ``data_path``'s arrays and its training set's self-kNN to
    ``out_path`` (default ``data_path + ".processed"``); returns it."""
    import h5py

    device = resolve_device(device)
    with h5py.File(data_path, "r") as f:
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"])
        neighbors = np.asarray(f["neighbors"])
        distances = np.asarray(f["distances"]) if "distances" in f else None

    train_knn = self_knn(train, k=k, metric=metric, device=device).cpu().numpy()

    out_path = out_path or data_path + ".processed"
    with h5py.File(out_path, "w") as f:
        f.create_dataset("train", data=train)
        f.create_dataset("train_knn", data=train_knn)
        f.create_dataset("test", data=test)
        f.create_dataset("neighbors", data=neighbors)
        if distances is not None:
            f.create_dataset("distances", data=distances)
    return out_path


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("data_key", choices=sorted(DATA_PATH_KEYS))
    p.add_argument("-k", type=int, default=100)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    data_path = get_env(DATA_PATH_KEYS[args.data_key])
    if not data_path:
        print(f"env var {DATA_PATH_KEYS[args.data_key]} is not set",
              file=sys.stderr)
        raise SystemExit(2)
    out = precompute(data_path, METRIC_BY_KEY[args.data_key], k=args.k,
                     out_path=args.out, device=args.device)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
