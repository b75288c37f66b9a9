"""Evaluation CLI (counterpart of `tools/eval.py`).

    python -m openstereo_tpu_torch.tools.eval --cfg_file cfgs/igev/igev_sceneflow_amp.yaml \\
        [--eval_data_cfg_file cfgs/kitti15_eval.yaml] [--data_paths roots.yaml] \\
        [--run_dir output/eval] [--ckpt N] [--pretrained x.pth] [--workers 2] [--device cpu]

The model and its dtype come from --cfg_file; --eval_data_cfg_file
replaces the config's DATA_CONFIG and EVALUATOR, for a cross-dataset
evaluation (`tools/eval.py:37-41`). Dataset roots come from --data_paths
(by DATASET name; `cfgs/data_paths.yaml` by default, when it exists). The
weights: a checkpoint of the run directory (--ckpt N, else the newest; -1
for none), then --pretrained, a reference OpenStereo `.pth` state_dict,
loaded strictly; without either, the trainer's seeded initialisation. The
evaluation is the port's `Trainer(run_mode="eval").evaluate`: the metrics
of EVALUATOR.METRIC, averaged over the set, in the run directory's
`metrics.jsonl` and printed. Loader workers are threads (--worker_type
process raises: ROADMAP item 8d); --model_par and --dist are item 20. Runs
on the CUDA card unless --device cpu is given (raises without a card).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--eval_data_cfg_file", default=None,
                   help="a YAML whose DATA_CONFIG and EVALUATOR replace the config's")
    p.add_argument("--run_dir", default="output/eval")
    p.add_argument("--ckpt", type=int, default=None,
                   help="checkpoint epoch of the run directory; the newest if omitted, -1 none")
    p.add_argument("--pretrained", default=None, help="reference OpenStereo .pth weights")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--worker_type", choices=["thread", "process"], default="thread")
    p.add_argument("--model_par", type=int, default=1)
    p.add_argument("--dist", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--data_paths", default="cfgs/data_paths.yaml",
                   help="YAML of dataset roots by DATASET name")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[object, Dict[str, float]]:
    """Evaluate as the arguments say; returns (the Trainer, the metrics)."""
    args = parse_args(argv)
    if args.model_par != 1 or args.dist:
        raise NotImplementedError("--model_par and --dist (mesh, multi-host) are ROADMAP item 20")

    from ..config import load_config
    from ..device import resolve_device
    from ..runtime import Trainer
    from .infer import load_pretrained
    from .train import inject_data_paths

    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    if args.eval_data_cfg_file:
        ecfg = load_config(args.eval_data_cfg_file)
        cfg["DATA_CONFIG"], cfg["EVALUATOR"] = ecfg.DATA_CONFIG, ecfg.EVALUATOR
    cfg = inject_data_paths(cfg, args.data_paths)
    trainer = Trainer(cfg, args.run_dir, run_mode="eval", num_workers=args.workers,
                      worker_type=args.worker_type, device=device)
    if args.ckpt is None or args.ckpt >= 0:
        trainer.resume_ckpt(args.ckpt)
    if args.pretrained:
        n = load_pretrained(trainer.model, args.pretrained)
        trainer.logger.info(f"loaded {n} tensors from {args.pretrained}")
    metrics = trainer.evaluate(0)
    print("eval: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return trainer, metrics


if __name__ == "__main__":
    main()
