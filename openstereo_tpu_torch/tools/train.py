"""Training CLI (counterpart of `tools/train.py`).

    python -m openstereo_tpu_torch.tools.train --cfg_file cfgs/lightstereo/lightstereo_s_sceneflow.yaml \\
        [--extra_tag tag] [--ckpt -1] [--device cpu] [--data_paths cfgs/data_paths.yaml]

Runs on the CUDA card unless --device cpu is given (raises without a card
otherwise). Dataset roots come from --data_paths (the JAX CLI's
`cfgs/data_paths.yaml` by default), by DATASET name; the run directory is
save_root/<Dataset>/<Model>/<cfg_name>/<tag>. Resume: --ckpt N, else the
config's MODEL.CKPT, else the newest checkpoint of the run directory;
--ckpt -1 starts afresh. --model_par and --dist (mesh and multi-host) are
ROADMAP item 20.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--save_root", default="output")
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--worker_type", choices=["thread", "process"], default="thread")
    p.add_argument("--ckpt", type=int, default=None,
                   help="resume epoch; latest if omitted and checkpoints exist")
    p.add_argument("--model_par", type=int, default=1)
    p.add_argument("--dist", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--data_paths", default="cfgs/data_paths.yaml",
                   help="YAML of dataset roots by DATASET name")
    return p.parse_args(argv)


def inject_data_paths(cfg, path: str = "cfgs/data_paths.yaml"):
    """Overwrite each DATA_INFOS entry's DATA_PATH from the machine-local
    mapping at `path`, when it exists (as the JAX CLI's `inject_data_paths`)."""
    if not os.path.exists(path):
        return cfg
    import yaml

    with open(path) as f:
        roots = yaml.safe_load(f) or {}
    for info in cfg.DATA_CONFIG.DATA_INFOS:
        if info.DATASET in roots:
            info.DATA_PATH = roots[info.DATASET]
    return cfg


def run_dir_for(args, cfg) -> str:
    ds = cfg.DATA_CONFIG.DATA_INFOS[0].DATASET.replace("Dataset", "")
    cfg_name = os.path.splitext(os.path.basename(args.cfg_file))[0]
    return os.path.join(args.save_root, ds, cfg.MODEL.NAME, cfg_name, args.extra_tag)


def main(argv: Optional[Sequence[str]] = None):
    """Train as the config says; returns the Trainer."""
    args = parse_args(argv)
    if args.model_par != 1 or args.dist:
        raise NotImplementedError("--model_par and --dist (mesh, multi-host) are ROADMAP item 20")

    from ..config import load_config
    from ..device import resolve_device
    from ..runtime import Trainer
    from ..utils import set_random_seed

    device = resolve_device(args.device)
    cfg = inject_data_paths(load_config(args.cfg_file), args.data_paths)
    set_random_seed(args.seed)
    trainer = Trainer(cfg, run_dir_for(args, cfg), run_mode="train", seed=args.seed,
                      num_workers=args.workers, worker_type=args.worker_type, device=device)
    ckpt = args.ckpt
    if ckpt is None and int(cfg.MODEL.get("CKPT", -1)) > -1:
        ckpt = int(cfg.MODEL.CKPT)
    if ckpt is None or ckpt >= 0:
        trainer.resume_ckpt(ckpt)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
