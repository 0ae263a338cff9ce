// cp.async helpers shared by the kernels that stage operands through a
// shared-memory ring (trim_conv2d.cu, trim_conv2d_fused.cu,
// trim_conv2d_wgrad.cu, flash_attention.cu, flash_attention_bwd.cu).  A copy
// with `valid` false writes zeros (src-size 0), which is how the loaders
// zero-fill virtual padding and tile ends without a branch around the copy.
#pragma once

// 16 bytes, L2 only (.cg): both pointers 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes (.ca: .cg takes only 16-byte copies): both pointers 8-byte
// aligned.  Four bf16 values.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

// 4 bytes (.ca: .cg takes only 16-byte copies).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
