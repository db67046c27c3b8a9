// K7-seg's backward for Hopper (sm_90a), BSHD layout: the stock Pallas
// flash attention backward given segment ids (_flash_attention_bwd_dkv and
// _flash_attention_bwd_dq, jax/experimental/pallas/ops/tpu/
// flash_attention.py:941, :1287, jax 0.9.0; the segment masks :866-872).
//
// The bodies are the one backward entry's (flash_bwd.cuh: backward_segment,
// the kSegment instances of its bodies; at bf16 head dim 64 the TMA +
// wgmma kernel of flash_bwd_sm90.cuh), built in a source of their own so
// that nvcc compiles them beside flash_attention.cu and flash_tail.cu, not
// after them. The forward that writes the out and lse it takes is
// flash_attention.cu's flash_attention_forward_segment_lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_bwd.cuh"

// dq, dk, dv of a forward with segment ids: q, k, v, o (its output), dout
// and the outputs are contiguous BSHD tensors of one type (bf16, is_bf16 =
// 1, or fp32); lse is that forward's (batch * heads, q_seq) fp32 output;
// delta fp32 scratch of the same size; dq_ws the Hopper kernel's fp32 dQ
// workspace when flash_segment_backward_takes_sm90 says it runs, else
// null; q_ids and kv_ids the forward's contiguous int32 (batch, q_seq) and
// (batch, kv_seq) ids. causal: key j visible to query i iff j <= i.
// Returns a cudaError_t.
extern "C" int flash_attention_backward_segment(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_ws, void* dq,
    void* dk, void* dv, const void* q_ids, const void* kv_ids, int batch,
    int q_seq, int kv_seq, int heads, int head_dim, float scale, int causal,
    int is_bf16, void* stream) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* ws = static_cast<float*>(dq_ws);
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return flash_bwd::backward_segment<true>(
        q, k, v, o, dout, l, dl, ws, dq, dk, dv, qi, ki, batch, q_seq, kv_seq,
        heads, head_dim, scale, is_bf16, st);
  return flash_bwd::backward_segment<false>(
      q, k, v, o, dout, l, dl, ws, dq, dk, dv, qi, ki, batch, q_seq, kv_seq,
      heads, head_dim, scale, is_bf16, st);
}

// 1 if flash_attention_backward_segment with these arguments runs the
// Hopper backward of flash_bwd_sm90.cuh (and needs its dQ workspace), else
// 0: its launch counter reads this.
extern "C" int flash_segment_backward_takes_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* dk, const void* dv, int head_dim, int is_bf16) {
  return bwd90::Sm90BwdTakes(is_bf16, head_dim, q, k, v, dout, dk, dv) ? 1
                                                                        : 0;
}

extern "C" const char* flash_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
