"""Training launcher (the reference's ``launch/train.py``): config -> params
-> a fault-tolerant train loop, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch small-llama --steps 100 --ckpt-dir DIR
    python -m repro_torch.launch.train --arch small-llama --steps 100 --device cpu

Wired here, as in the reference: the deterministic, restart-safe data
pipeline (its state saved in the checkpoint's extra), checkpoints with
rotation and atomic renames (async between steps, blocking at the end),
the step guard (a NaN or divergent step keeps the old params and state)
with a rollback to the latest checkpoint after repeated bad steps, the
straggler watchdog, and optional int8 + error-feedback gradients.

``train_small_lm`` is the reference benchmarks' recipe for the ``small-*``
models (``benchmarks/common.py``): 300 steps of batch 16 x 128 tokens of
the "mix" domain, lr 1e-3 with 20 warmup steps and a cosine decay, weight
decay 0.01, one blocking save of the params to
``experiments/models/<name>/step_00000000``, the layout the reference's
``train_small_lm`` and the port's ``launch.serve.load_small`` read.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import LMDataPipeline, PipelineState
from repro_torch.launch.steps import StepConfig, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, AdamWState, init_state, linear_warmup_cosine
from repro_torch.runtime.fault import FaultHandler, GuardConfig
from repro_torch.runtime.straggler import StepTimeWatchdog

logger = logging.getLogger(__name__)

MODELS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "models")
SMALL_SEQ = 128


def _trainer(cfg, steps: int, lr: float, weight_decay: float, seed: int, dev: torch.device,
             step_cfg: StepConfig):
    """Params from ``seed``, fresh AdamW state and the train step (warmup 20,
    cosine over ``steps``): what both loops below start from."""
    model = build_model(cfg)
    params = model.init(seed, dev)
    opt_cfg = AdamWConfig(lr=lr, weight_decay=weight_decay,
                          schedule=linear_warmup_cosine(20, steps))
    return params, init_state(params), make_train_step(model, opt_cfg, step_cfg)


def train_loop(arch: str = "small-llama", steps: int = 200, batch: int = 8, seq: int = 128,
               lr: float = 1e-3, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = True, reduced: bool = True, grad_compress: bool = False,
               seed: int = 0, device: Device = None):
    """Train ``arch`` for ``steps`` steps, resuming from the latest
    checkpoint in ``ckpt_dir`` when there is one.  Returns (params,
    opt_state, the last step's metrics)."""
    dev = resolve_device(device)
    cfg = get_config(arch)  # the small-* archs at their own widths
    if reduced and not arch.startswith("small-"):
        cfg = cfg.reduced()
    params, opt, step_fn = _trainer(cfg, steps, lr, AdamWConfig.weight_decay, seed, dev,
                                    StepConfig(grad_compress=grad_compress))

    pipe_state = PipelineState(seed=seed, step=0, domain="en_a")
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    handler = FaultHandler(GuardConfig(), mgr)
    watchdog = StepTimeWatchdog()

    def restore():
        (p, o), extra, at = mgr.restore(device=dev)
        return p, AdamWState(*o), PipelineState.from_dict(extra["pipeline"]), at

    if mgr is not None and resume and mgr.latest_step() is not None:
        params, opt, pipe_state, start_step = restore()
        logger.info("resumed from step %d", start_step)

    pipe = LMDataPipeline(cfg.vocab_size, batch, seq, pipe_state, device=dev)
    grad_error = None
    metrics: Dict = {}
    for step in range(start_step, steps):
        watchdog.step_start()
        b = next(pipe)
        if grad_compress:
            params, opt, metrics, grad_error = step_fn(params, opt, b, grad_error)
        else:
            params, opt, metrics = step_fn(params, opt, b)
        bad = bool(metrics["bad_step"])  # the loop's one host read a step
        verdict = watchdog.step_end()
        if handler.observe(bad) == "reload":
            params, opt, pipe.state, rstep = restore()
            logger.warning("rolled back to step %d", rstep)
            continue
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, (params, opt), {"pipeline": pipe.state.to_dict()})
        if verdict == "trip":
            logger.warning("straggler watchdog tripped (median %.3fs)", watchdog.median_step)
    if mgr is not None:
        mgr.save(steps, (params, opt), {"pipeline": pipe.state.to_dict()}, block=True)
    return params, opt, metrics


def train_small_lm(name: str, steps: int = 300, batch: int = 16, lr: float = 1e-3,
                   device: Device = None, log_every: int = 50,
                   ckpt_dir: Optional[str] = None, seed: int = 0):
    """The reference's small-LM recipe on ``device``; saves the params
    (blocking, ``keep=1``) under ``ckpt_dir`` (default
    ``experiments/models/<name>``).  Returns (params, extra): extra holds
    ``steps``, ``final_loss`` (the last logged loss) and ``losses`` (every
    ``log_every``-th step's loss, the first step's too)."""
    dev = resolve_device(device)
    cfg = get_config(name)
    params, opt, step_fn = _trainer(cfg, steps, lr, 0.01, seed, dev, StepConfig())
    pipe = LMDataPipeline(cfg.vocab_size, batch, SMALL_SEQ,
                          PipelineState(seed=0, step=0, domain="mix"), device=dev)
    t0 = time.perf_counter()
    losses = {}
    for i in range(steps):
        params, opt, metrics = step_fn(params, opt, next(pipe))
        if i == 0 or (i + 1) % log_every == 0:
            losses[i + 1] = float(metrics["loss"])
            logger.info("[%s] step %d/%d loss=%.3f (%.0fs)", name, i + 1, steps,
                        losses[i + 1], time.perf_counter() - t0)
    extra = {"steps": steps, "final_loss": losses[max(losses)] if losses else None,
             "losses": {str(k): v for k, v in losses.items()}}
    mgr = CheckpointManager(ckpt_dir or os.path.join(MODELS_DIR, name), keep=1,
                            async_save=False)
    mgr.save(0, params, extra, block=True)
    return params, extra


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="small-llama")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for a CPU run)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    t0 = time.time()
    _, _, metrics = train_loop(arch=args.arch, steps=args.steps, batch=args.batch,
                               seq=args.seq, ckpt_dir=args.ckpt_dir,
                               grad_compress=args.grad_compress, device=args.device)
    if torch.cuda.is_available() and resolve_device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"done in {time.time() - t0:.1f}s; final metrics: "
          f"{ {k: float(v) for k, v in metrics.items()} }")


if __name__ == "__main__":
    main()
