"""Training CLI (port of :mod:`nlsh_tpu.cli.train`):

    python3 -m nlsh_tpu_torch.cli.train --data_id <id> \\
        [--learner_type triplet] [--n_tables 8] [--device cuda]

The JAX package's flags, defaults and hashing-type / distance rules, plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU).
``--learner_type hnsw`` builds the HNSW baseline on the host (the
dataset's ground truth is computed on ``--device``).  ``--n_devices N``
(N > 1) trains data-parallel over N devices of ``--device``'s kind;
processes named by ``NLSH_COORDINATOR`` / ``NLSH_NUM_PROCESSES`` /
``NLSH_PROCESS_ID`` (or ``NLSH_AUTO_DISTRIBUTED=1``) join one
``torch.distributed`` group first
(:func:`nlsh_tpu_torch.parallel.multihost.initialize_from_env`).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from datetime import datetime

import torch

from nlsh_tpu_torch.data import get_data_by_id
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.code_distances import get_code_distance
from nlsh_tpu_torch.train.base import resolve_device
from nlsh_tpu_torch.utils import loggers as L
from nlsh_tpu_torch.utils.env import get_env


def comma_separate_ints(value: str) -> list[int]:
    try:
        return [int(i) for i in value.split(",")]
    except Exception:
        raise argparse.ArgumentTypeError(
            f"{value} is not a valid encoder structure."
            "Should be comma separated integers, e.g. '256,256'")


def nlsh_argparse() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-hs", "--hash_size", type=int, default=12)
    p.add_argument("-es", "--encoder_structure", type=comma_separate_ints,
                   default="256,256")
    p.add_argument("-et", "--encoder_type", default="siren",
                   choices=("siren", "mlp"))
    p.add_argument("-ht", "--hashing_type", default="MultivariateBernoulli",
                   choices=("MultivariateBernoulli", "MultivariateBernoulliTanh",
                            "Categorical", "ProductQuantization"))
    p.add_argument("-dt", "--distance_type", default="L2",
                   choices=("L2", "JS", "KL", "MeanKL", "CrossEntropy", "Cosine"))
    p.add_argument("--data_id", required=True)
    p.add_argument("--logger_type", default=None,
                   choices=("tensorboard", "cometml", "wandb", "jsonl"))
    p.add_argument("--log_tags", default=None)
    p.add_argument("--learner_type", default="triplet",
                   choices=("triplet", "siamese", "vqvae", "proposed", "ae",
                            "hnsw"))
    p.add_argument("-tm", "--triplet_margin", type=float, default=0.1)
    p.add_argument("-tpk", "--triplet_positive_k", type=int, default=None)
    p.add_argument("-tnsm", "--triplet_negative_sampling_method", type=str,
                   default="random",
                   choices=("random", "nearest", "hard", "semi-hard"))
    p.add_argument("--balance_lambda", type=float, default=0.0,
                   help="bucket-balance regulariser weight (triplet)")
    p.add_argument("-spm", "--siamese_positive_margin", type=float, default=0.0)
    p.add_argument("-snm", "--siamese_negative_margin", type=float, default=0.1)
    p.add_argument("-spr", "--siamese_positive_rate", type=float, default=0.1)
    p.add_argument("--n_tables", type=int, default=1,
                   help="train an L-table ensemble jointly (triplet/"
                        "siamese/proposed learners)")
    p.add_argument("--lambda1", type=float, default=2e-2)
    p.add_argument("-bs", "--batch_size", type=int, default=1024)
    p.add_argument("-lr", "--learning_rate", type=float, default=3e-4)
    p.add_argument("--lr_schedule", default="constant",
                   choices=("constant", "cosine", "linear"),
                   help="LR decay over the run to 5%% of the peak")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--test_every_updates", type=int, default=300)
    p.add_argument("--hash_times", type=int, default=10)
    p.add_argument("--probe_mode", default="sample",
                   choices=("sample", "flip"),
                   help="multi-probe strategy of the eval queries")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel training over N devices of "
                        "--device's kind")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--model_save_dir", type=str, default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the training and its evals")
    return p


def get_hashing_from_args(args, enc):
    """The hashing head of ``args``, with the JAX package's type /
    distance compatibility rules."""
    ht, dt = args.hashing_type, args.distance_type
    if ht in ("Categorical", "ProductQuantization"):
        if dt not in ("L2", "JS"):
            raise RuntimeError(f"{dt} is not valid for {ht}")
        dist = get_code_distance("CategoricalL2" if dt == "L2" else "JS")
        # Categorical has 2**hash_size buckets, as the reference CLI
        size = int(2 ** args.hash_size) if ht == "Categorical" \
            else args.hash_size
        return get_hashing(ht, enc, size, dist)
    if ht == "MultivariateBernoulli":
        if dt not in ("L2", "KL", "MeanKL", "CrossEntropy"):
            raise RuntimeError(f"{dt} is not valid for {ht}")
        return get_hashing(ht, enc, args.hash_size, get_code_distance(dt))
    if ht == "MultivariateBernoulliTanh":
        if dt != "Cosine":
            raise RuntimeError(f"{dt} is not valid for {ht}")
        return get_hashing(ht, enc, args.hash_size, get_code_distance(dt))
    raise RuntimeError(f"{ht} is not a valid hashing type")


def get_logger_from_args(args):
    if args.debug or args.logger_type is None:
        logger = L.NullLogger()
    elif args.logger_type == "jsonl":
        log_dir = get_env("NLSH_LOG_DIR",
                          os.path.join(tempfile.gettempdir(), "nlsh_logs"))
        run_name = f"{args.learner_type}_{datetime.now():%Y%m%d-%H%M%S}"
        logger = L.JSONLLogger(f"{log_dir}/{run_name}.jsonl", run_name,
                               echo=True)
    elif args.logger_type == "tensorboard":
        base = get_env("NLSH_TENSORBOARD_LOG_DIR",
                       os.path.join(tempfile.gettempdir(), "nlsh_tb"))
        run_name = (f"{int(2 ** args.hash_size)}_{args.learner_type}"
                    f"_{datetime.now():%Y%m%d-%H%M%S}")
        logger = L.TensorboardX(f"{base}/{run_name}", run_name)
    elif args.logger_type == "cometml":
        tags = args.log_tags.split(",") if args.log_tags else None
        logger = L.CometML(api_key=get_env("NLSH_COMET_API_KEY"),
                           project_name=get_env("NLSH_COMET_PROJECT_NAME"),
                           workspace=get_env("NLSH_COMET_WORKSPACE"),
                           debug=args.debug, tags=tags)
    elif args.logger_type == "wandb":
        logger = L.WandB(args.log_tags.split(",") if args.log_tags else None)
    else:
        raise RuntimeError(f"{args.logger_type} is not a valid logger type")

    logger.meta(params={
        "k": args.k,
        "hash_size": args.hash_size,
        "encoder_structure": ",".join(map(str, args.encoder_structure)),
        "encoder_type": args.encoder_type,
        "distance_type": args.distance_type,
        "data_id": args.data_id,
        "learning_rate": args.learning_rate,
        "batch_size": args.batch_size,
        "device": args.device,
    })
    logger.args(" ".join(sys.argv[1:]))
    return logger


def get_learner_from_args(args, hashing, data, logger, model_save_dir):
    from nlsh_tpu_torch import train as T

    if args.learner_type == "triplet":
        logger.meta(params={
            "learner_type": "triplet",
            "triplet_margin": args.triplet_margin,
            "triplet_positive_k": args.triplet_positive_k,
            "triplet_negative_sampling_method":
                args.triplet_negative_sampling_method,
            "lambda1": args.lambda1,
        })
        return T.TripletTrainer(
            hashing, data, model_save_dir, logger, lambda1=args.lambda1,
            margin=args.triplet_margin, positive_k=args.triplet_positive_k,
            negative_sampling_method=args.triplet_negative_sampling_method,
            balance_lambda=args.balance_lambda)
    if args.learner_type == "siamese":
        logger.meta(params={
            "learner_type": "siamese",
            "siamese_positive_margin": args.siamese_positive_margin,
            "siamese_negative_margin": args.siamese_negative_margin,
            "siamese_positive_rate": args.siamese_positive_rate,
            "lambda1": args.lambda1,
        })
        return T.SiameseTrainer(
            hashing, data, model_save_dir, logger, lambda1=args.lambda1,
            positive_margin=args.siamese_positive_margin,
            negative_margin=args.siamese_negative_margin,
            positive_rate=args.siamese_positive_rate)
    if args.learner_type == "vqvae":
        logger.meta(params={"learner_type": "vqvae"})
        return T.VQVAETrainer(hashing, data, model_save_dir, logger)
    if args.learner_type == "proposed":
        logger.meta(params={"learner_type": "proposed",
                            "lambda1": args.lambda1})
        return T.ProposedTrainer(hashing, data, model_save_dir, logger,
                                 train_k=10, lambda1=args.lambda1)
    if args.learner_type == "ae":
        logger.meta(params={"learner_type": "ae"})
        return T.AETrainer(hashing, data, model_save_dir, logger)
    if args.learner_type == "hnsw":
        logger.meta(params={"learner_type": "hnsw"})
        return T.HNSWBaseline(data, logger, seed=args.seed)
    raise RuntimeError(f"unknown learner {args.learner_type}")


def main(argv: list[str] | None = None):
    args = nlsh_argparse().parse_args(argv)
    # joins the processes named by NLSH_COORDINATOR / NLSH_NUM_PROCESSES /
    # NLSH_PROCESS_ID (or NLSH_AUTO_DISTRIBUTED) before any device use; a
    # no-op without them
    from nlsh_tpu_torch.parallel.multihost import initialize_from_env

    initialize_from_env(platform=torch.device(args.device).type)
    device = resolve_device(args.device)
    model_save_dir = args.model_save_dir or get_env(
        "NLSH_MODEL_SAVE_DIR", os.path.join(tempfile.gettempdir(),
                                            "nlsh_models"))

    print("=== read data ===")
    data = get_data_by_id(args.data_id, device=device)
    data.load()
    print("=== prepare encoder ===")
    enc = get_encoder(args.encoder_type, data.dim, args.encoder_structure)
    hashing = get_hashing_from_args(args, enc)
    logger = get_logger_from_args(args)
    print("=== prepare learner ===")
    learner = get_learner_from_args(args, hashing, data, logger,
                                    model_save_dir)
    if args.n_tables > 1:
        from nlsh_tpu_torch.train import MultiTableTrainer

        logger.meta(params={"n_tables": args.n_tables})
        learner = MultiTableTrainer(learner, args.n_tables)

    mesh = None
    if args.n_devices is not None and args.n_devices > 1:
        # data-parallel fit: each step's batch split over the devices
        from nlsh_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.n_devices, axis="data", platform=device.type)
        logger.meta(params={"n_devices": args.n_devices})

    print("Start training")
    return learner.fit(
        K=args.k, batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        test_every_updates=args.test_every_updates, epochs=args.epochs,
        hash_times=args.hash_times, probe_mode=args.probe_mode,
        seed=args.seed, max_steps=args.max_steps,
        resume_from=args.resume_from, mesh=mesh,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        device=device)


if __name__ == "__main__":
    main()
