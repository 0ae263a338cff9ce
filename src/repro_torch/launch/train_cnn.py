"""End-to-end CNN training on the TrIM kernels (the counterpart of
``examples/train_cnn.py``).

A small CIFAR-shaped classifier (``models.layers.simple_cnn_params``:
channels (8, 16), a depthwise stage, a mean-pool + dense head) trains with
AdamW on a synthetic but learnable task: each class has a fixed random
template (``np.random.default_rng(0)``), a sample is its template plus
0.4 x Gaussian noise, the label is the template index.  Every conv runs
the TrIM kernels in all three directions: the forward kernel, the input
gradient through the same kernel on the dilated cotangent, and the
weight-gradient kernel.  Before the first step, ``tune_backward_shapes``
seeds the autotune cache with both cotangents of every conv the model
trains through (``core.autotune.tune_backward``).  With ``--steps
>= 40`` the mean of the last five losses must be below the mean of the
first five minus 0.1, the example's acceptance check.

Not here, unlike the JAX example: ``--devices/--data/--spatial`` (the
sharded halo-exchange path, ROADMAP Queue 1: multi-GPU).  The weights
come from ``torch.Generator().manual_seed(0)``, not from ``jax.random``,
so the loss curve is not the JAX example's.

  PYTHONPATH=src python -m repro_torch.launch.train_cnn            # card
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --device cpu \\
      --steps 12
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import autotune
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import conv_pads
from repro_torch.models import layers
from repro_torch.models.base import init_params
from repro_torch.optim import AdamWConfig, adamw

IMAGE, CIN, N_CLASSES = 32, 3, 10
CHANNELS = (8, 16)
NOISE = 0.4
OPT = AdamWConfig(lr=1e-2, warmup_steps=3, decay_steps=300,
                  weight_decay=0.0)


def make_batch(rng: np.random.Generator, templates: np.ndarray, batch: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """Noisy class templates; labels are the template indices."""
    labels = rng.integers(0, templates.shape[0], size=batch)
    x = templates[labels] + NOISE * rng.standard_normal(
        (batch, *templates.shape[1:]))
    return (torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(labels).to(device))


def tune_backward_shapes(batch: int, *, device=None,
                         measure: bool = False) -> dict:
    """Seed the autotune cache for every backward conv shape the model
    trains through (``examples/train_cnn.py:74-92``): per conv, the
    input-gradient conv's ``conv2d:`` record and the weight gradient's
    ``conv2d_wgrad:`` record (``autotune.tune_backward``), keyed by the
    unpadded input and the 'same' pads, as the backward looks them up.
    Returns ``{name: {"input_grad": rec, "weight_grad": rec}}``."""
    shapes, cur = [], (batch, IMAGE, IMAGE, CIN)
    for i, c in enumerate(CHANNELS):
        shapes.append((f"conv{i}", cur, (3, 3, cur[3], c), 1, 1))
        shapes.append((f"down{i}", cur[:3] + (c,), (3, 3, c, c), 2, 1))
        cur = (cur[0], -(-cur[1] // 2), -(-cur[2] // 2), c)
    c = CHANNELS[-1]
    up = (batch, IMAGE // 2, IMAGE // 2, c)
    shapes.insert(3, ("dw", up, (3, 3, 1, c), 1, c))      # depthwise
    return {name: autotune.tune_backward(
        x_shape, w_shape, stride=stride,
        pad=conv_pads(x_shape[1], x_shape[2], 3, stride, "same"),
        groups=groups, device=device, measure=measure)
        for name, x_shape, w_shape, stride, groups in shapes}


def nll_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels under log-softmax, in
    f32 (bf16 logits are widened first)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def train_step(params: dict, moments: dict, step, x: torch.Tensor,
               y: torch.Tensor, *, apply_fn, cfg: AdamWConfig):
    """One AdamW step on ``nll_loss(apply_fn(params, x), y)``.

    Functional, as the JAX example's jitted step: returns ``(new_params,
    new_moments, loss, metrics)`` and leaves its inputs untouched.  A bf16
    tree trains on the bf16 kernels; its moments stay f32 and each leaf
    is rounded to bf16 once per step (``adamw.apply_updates``).
    """
    leaves = adamw.tree_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    loss = nll_loss(apply_fn(adamw.tree_unflatten(params, live), x), y)
    grads = torch.autograd.grad(loss, live)
    params, moments, metrics = adamw.apply_updates(
        params, adamw.tree_unflatten(params, grads), moments, step, cfg)
    return params, moments, loss.detach(), metrics


def train(*, steps: int = 50, batch: int = 16, device=None,
          log=print) -> dict:
    """The example's loop on ``device`` (default ``"cuda"``), after
    :func:`tune_backward_shapes`.  Returns ``{"losses", "first", "last",
    "ms_per_step", "device"}``; raises ``RuntimeError`` when ``steps >=
    40`` and the loss did not fall."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    recs = tune_backward_shapes(batch, device=dev)
    log(f"tuned the backward shapes of {len(recs)} convs in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    templates = rng.standard_normal((N_CLASSES, IMAGE, IMAGE, CIN))
    params = init_params(
        layers.simple_cnn_params(cin=CIN, channels=CHANNELS,
                                 n_classes=N_CLASSES),
        torch.Generator().manual_seed(0), device=dev)
    moments = adamw.init_moments(params, OPT)

    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        x, y = make_batch(rng, templates, batch, dev)
        params, moments, loss, metrics = train_step(
            params, moments, i, x, y, apply_fn=layers.simple_cnn_apply,
            cfg=OPT)
        losses.append(float(loss))
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.4f}  "
                f"|g| {float(metrics['grad_norm']):.3f}")
    dt = time.perf_counter() - t0
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"loss {first:.4f} -> {last:.4f} over {steps} steps "
        f"({dt / steps * 1e3:.1f} ms/step on {name}, every conv on the "
        f"TrIM kernels forward and backward)")
    if steps >= 40 and not last < first - 0.1:
        raise RuntimeError(f"training did not learn: {first:.4f} -> "
                           f"{last:.4f}")
    return dict(losses=losses, first=first, last=last,
                ms_per_step=dt / steps * 1e3, device=name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--json", default=None, metavar="OUT.json")
    args = ap.parse_args(argv)
    out = train(steps=args.steps, batch=args.batch, device=args.device)
    if args.steps >= 40:
        print("OK: loss decreased")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(out, steps=args.steps), f)


if __name__ == "__main__":
    main()
