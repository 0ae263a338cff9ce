"""Batched LM serving driver (the counterpart of ``repro/launch/serve.py``):
prefill a batch of prompts token by token through the decode step, then
greedy decode, with the per-family state on the device (KV caches; the
conv windows and SSM states of falcon-mamba-7b; the ring KV caches, conv
windows and LRU states of recurrentgemma-2b; the decoder's KV caches and
the static cross caches of seamless-m4t-large-v2 through ``serve_batch``,
which ``main`` does not drive, as JAX's does not).  The MoE family
(qwen3-moe-30b-a3b, phi3.5-moe-42b-a6.6b) serves as the dense one does:
each decode step routes the batch's B tokens as one group.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --smoke --batch 4 --prompt-len 16 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu

Without ``--device`` it runs on the card and raises where PyTorch sees no
GPU.  ``serve_batch`` runs f32, as JAX's entry point forces; a full-width
config must fit the card in f32 (qwen3-moe-30b-a3b's 122 GB does not).
Weights are random, drawn from seed 0 on the device; prompts come
from ``np.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.distributed import steps
from repro_torch.models import api
from repro_torch.models.base import init_params


def serve_batch(cfg, params: dict, prompts: torch.Tensor,
                gen: int) -> torch.Tensor:
    """prompts: (B, P) int on the params' device.  Returns the (B, P + gen)
    sequences: the prompts, then ``gen`` greedy tokens."""
    b, p = prompts.shape
    max_len = p + gen + 1
    state = init_params(api.decode_state(cfg, b, max_len),
                        torch.Generator(), device=prompts.device)
    decode = steps.make_decode_step(cfg)
    seqs = [prompts]
    # prefill token by token through the decode path (state-exact for every
    # family; the flash-kernel prefill is make_prefill_step)
    tok = prompts[:, :1]
    for t in range(1, max_len):
        batch = {"tokens": tok,
                 "cache_len": torch.full((b,), t, dtype=torch.int32,
                                         device=prompts.device)}
        nxt, state = decode(params, state, batch)
        if t < p:                      # still consuming the prompt
            tok = prompts[:, t:t + 1]
        else:
            tok = nxt[:, None].to(prompts.dtype)
            seqs.append(tok)
        if len(seqs) == gen + 1:
            break
    return torch.cat(seqs, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mod = registry.get(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    if cfg.family == "encdec":
        # JAX's message (repro/launch/serve.py:64), and the port's call
        raise SystemExit("use examples/serve_lm.py for enc-dec serving "
                         "(the port: launch.serve.serve_batch)")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(api.params(cfg), gen, device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    t0 = time.time()
    out = serve_batch(cfg, params, prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_tok = args.batch * args.gen
    print(f"arch={args.arch} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s batch-aggregate)")
    print("sample:", out[0].cpu().numpy()[:24])
    return out


if __name__ == "__main__":
    main()
