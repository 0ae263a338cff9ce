"""LM training entry point (the counterpart of ``repro/launch/
train.py``): config -> train state -> train loop with checkpoint/restart,
a straggler watchdog and metrics logging, on one card.

Usage (``--device cpu`` runs the plain versions; keep the model small):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --device cpu --steps 20 --batch 8 --seq 64 \\
      --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 4 --batch 2 --seq 1025           # full width on the card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --smoke --device cpu --steps 20 --batch 8 \\
      --seq 64 --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --steps 4 --batch 1 --seq 4097   # the card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu --steps 10 --batch 8 \\
      --seq 64 --ckpt-dir "$(mktemp -d)"

The flags and their defaults are JAX's, plus ``--device`` (default
``cuda``) and ``--json OUT``; ``--model-parallel`` other than 1 raises
(ROADMAP Queue 1 item 9).  The dense (qwen2.5-3b, starcoder2-3b/7b,
...), MoE (qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b: the loss adds the
routers' load-balance aux; neither fits one card in f32 at full depth),
ssm (falcon-mamba-7b, whose 116 GB of f32 state does not fit one
card at full depth) and hybrid (recurrentgemma-2b) families train.
Attention runs the flash kernels forward and backward
(``attn_impl="flash"``, the port's default), the temporal conv the conv1d
kernels forward and backward, and each block is rematerialised
(``remat``).  The encoder-decoder family (seamless-m4t-large-v2) is
refused: the synthetic stream feeds no ``src`` frames (JAX's trainer
fails there with a ``KeyError``); ``steps.make_train_step`` trains it on
a batch that carries them.  Every ``--ckpt-every`` steps, and at the end, the train
state and the data-iterator state are written atomically; on startup the
latest checkpoint in ``--ckpt-dir`` is restored, so a restart resumes
exactly.  The weights come from
``torch.Generator(device).manual_seed(0)``, not ``jax.random``: a JAX
checkpoint restores here, but a fresh run does not start from JAX's
weights.  The last line printed is JAX's JSON object ``{"final_loss",
"steps", "straggler_flags"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.distributed import steps
from repro_torch.optim import AdamWConfig


class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running EMA."""

    def __init__(self, threshold: float = 3.0, alpha: float = 0.1):
        self.ema = None
        self.threshold = threshold
        self.alpha = alpha
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.flagged += 1
        return slow


def main(argv=None) -> dict:
    """Run the loop; print JAX's final JSON line and return it with
    ``losses``, ``grad_norms``, ``step_ms`` (host clock, synchronised),
    ``device`` and ``arch`` added (also what ``--json`` writes), and the
    final train state under ``state``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--task", default="copy")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--json", default=None, metavar="OUT.json")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the port trains on "
            "one card; model parallelism is ROADMAP Queue 1 item 9 "
            "(multi-GPU)")
    mod = registry.get(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    if cfg.family == "encdec":
        raise SystemExit(
            f"--arch {args.arch}: the encoder-decoder family needs a src "
            "stream (frame embeddings) beside tokens and labels, and the "
            "trainer's SyntheticStream feeds none; train it through "
            "distributed.steps.make_train_step on a batch that carries "
            "src")
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          decay_steps=args.steps)
    dc = DataConfig(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                    task=args.task)

    step_fn = steps.make_train_step(cfg, opt_cfg, n_micro=args.n_micro)
    state = steps.init_train_state(
        cfg, opt_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    stream = SyntheticStream(dc)
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        restored, manifest = mgr.restore(state)
        if restored is not None:
            state = restored
            stream = SyntheticStream.from_state(dc, manifest["data_state"])
            print(f"resumed from step {manifest['step']}")

    watchdog = StragglerWatchdog()
    losses, grad_norms, step_ms = [], [], []
    start = int(state["step"])
    for i in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # waits for the step
        dt = time.time() - t0
        grad_norms.append(float(metrics["grad_norm"]))
        step_ms.append(dt * 1e3)
        if watchdog.observe(dt):
            print(f"[watchdog] step {i} straggled: {dt:.3f}s "
                  f"(ema {watchdog.ema:.3f}s)")
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms",
                  flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, meta={"data_state": stream.state(),
                                         "arch": args.arch})
    if mgr:
        mgr.save(args.steps, state, meta={"data_state": stream.state(),
                                          "arch": args.arch})
    final = {"final_loss": losses[-1] if losses else None,
             "steps": args.steps, "straggler_flags": watchdog.flagged}
    print(json.dumps(final))
    out = dict(final, losses=losses, grad_norms=grad_norms,
               step_ms=step_ms, arch=args.arch,
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f)
    return dict(out, state=state)


if __name__ == "__main__":
    main()
