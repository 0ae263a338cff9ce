// The conv epilogue shared by every forward kernel of the port: the
// activation applied after `acc + bias`.  trim_conv2d.cu and
// trim_conv2d_fused.cu both compute an output element's sum in one order of
// its route (the fmaf chain in (ki, kj, ci) order, or bf16_mma.cuh's
// k-steps), then `+ bias`, then activate() below, so a fused group is
// bitwise equal to the per-layer chain (ROADMAP Queue 3).  Keep the one
// definition here: two copies could be compiled differently.
#pragma once

// act: 0 none, 1 relu, 2 gelu (tanh form, as jax.nn.gelu), 3 silu
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v < 0.0f ? 0.0f : v;
  if (act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (act == 3) return v / (1.0f + expf(-v));
  return v;
}
