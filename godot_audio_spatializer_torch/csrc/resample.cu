// Fixed-point linear resampler: one block of F frames for every source.
//
// Replaces godot_audio_spatializer_tpu/ops/pallas/resample_kernel.py:
// resample_block_kernel (_resample_kernel).  The TPU kernel gathers each
// source's 128-aligned window into VMEM first and then selects the two
// interpolation taps with one-hot MXU matmuls (a bf16 hi/lo split dot),
// because the TPU has no fast per-element gather.  Hopper has one: each
// thread computes its frame's 16-bit fixed-point position and reads the
// two taps straight from the bank, so neither the one-hot products nor
// the materialised [N, R*128, 2] window exist here.
//
// What bounds it on the card: the bytes.  It writes N*F*2 f32 frames
// (16.8 MB at N=4096, F=512) and reads about F*pitch*8 bytes of bank per
// source, which mostly hits L2 (the whole bank is ~3 MB).  Design: one
// thread block per source, one thread per output frame, so a warp
// writes 32 consecutive frames (256 contiguous bytes interleaved, 128
// bytes per channel plane in the raw layout) and its taps fall in a few
// neighbouring cache lines.  The per-source count of mixed frames is a
// block reduction (__syncthreads_count), not a second pass.
//
// Semantics (bit-identical positions to ops/resample.py, and to the
// plain twin in ops/kernels/resample.py):
//   start_al = (cursor_idx >> 7) << 7,  off = cursor_idx & 127
//   acc  = cursor_frac + i*pitch_frac;  rel = off + i*pitch_int + (acc >> 16)
//   frac = (acc & 0xFFFF) / 65536;      valid = loop || rel <= lim
//   window row r of the source reads bank row clip(row0 + r, 0, rows-1)
//   (row0 = (base + start_al) >> 7), rel is clipped to [0, R*128-2]
//   y = valid ? s0*(1-frac) + s1*frac : 0        (f32, no FMA: -fmad=false
//   and explicit _rn intrinsics keep the twin's rounding)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;
constexpr int kThreads = 256;

template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const float2* __restrict__ bank, int num_rows,
                const int* __restrict__ base, const int* __restrict__ length,
                const uint8_t* __restrict__ loop,
                const int* __restrict__ cursor_idx,
                const int* __restrict__ cursor_frac,
                const int* __restrict__ pitch_fp, int n_src, int frames,
                int win_rows, float* __restrict__ out, int* __restrict__ mixed) {
  const int n = blockIdx.x;
  const int cidx = cursor_idx[n];
  const int cfrac = cursor_frac[n];
  const int pfp = pitch_fp[n];
  const int pint = pfp >> 16;
  const int pfrac = pfp & 0xFFFF;
  const int start_al = (cidx >> 7) << 7;
  const int off = cidx & (kRow - 1);
  const int row0 = (base[n] + start_al) >> 7;
  const int lim = max(length[n], 1) - 1 - start_al;
  const bool lp = loop[n] != 0;
  const int rel_max = win_rows * kRow - 2;

  int count = 0;
  for (int f0 = 0; f0 < frames; f0 += kThreads) {
    const int f = f0 + threadIdx.x;
    bool valid = false;
    if (f < frames) {
      const int acc = cfrac + f * pfrac;
      const int rel_u = off + f * pint + (acc >> 16);
      const float frac = __fmul_rn((float)(acc & 0xFFFF), 1.0f / 65536.0f);
      valid = lp || rel_u <= lim;
      const int rel = min(max(rel_u, 0), rel_max);
      const int r0 = min(max(row0 + (rel >> 7), 0), num_rows - 1);
      const int r1 = min(max(row0 + ((rel + 1) >> 7), 0), num_rows - 1);
      const float2 s0 = bank[r0 * kRow + (rel & (kRow - 1))];
      const float2 s1 = bank[r1 * kRow + ((rel + 1) & (kRow - 1))];
      const float w0 = __fsub_rn(1.0f, frac);
      float yl = 0.0f, yr = 0.0f;
      if (valid) {
        yl = __fadd_rn(__fmul_rn(s0.x, w0), __fmul_rn(s1.x, frac));
        yr = __fadd_rn(__fmul_rn(s0.y, w0), __fmul_rn(s1.y, frac));
      }
      if (kRaw) {
        // [2, F/128, n_src, 128]
        const int chunk = f >> 7, fl = f & (kRow - 1), nch = frames / kRow;
        out[((size_t)(0 * nch + chunk) * n_src + n) * kRow + fl] = yl;
        out[((size_t)(1 * nch + chunk) * n_src + n) * kRow + fl] = yr;
      } else {
        // [N, F, 2]
        reinterpret_cast<float2*>(out)[(size_t)n * frames + f] = make_float2(yl, yr);
      }
    }
    count += __syncthreads_count(valid);
  }
  if (threadIdx.x == 0) mixed[n] = count;
}

}  // namespace

extern "C" int gas_resample(const void* bank, int num_rows, const void* base,
                            const void* length, const void* loop,
                            const void* cursor_idx, const void* cursor_frac,
                            const void* pitch_fp, int n_src, int frames,
                            int win_rows, int raw, void* out, void* mixed,
                            void* stream) {
  if (n_src <= 0) return 0;
  dim3 grid(n_src), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* b = static_cast<const float2*>(bank);
  if (raw) {
    resample_kernel<true><<<grid, block, 0, s>>>(
        b, num_rows, (const int*)base, (const int*)length, (const uint8_t*)loop,
        (const int*)cursor_idx, (const int*)cursor_frac, (const int*)pitch_fp,
        n_src, frames, win_rows, (float*)out, (int*)mixed);
  } else {
    resample_kernel<false><<<grid, block, 0, s>>>(
        b, num_rows, (const int*)base, (const int*)length, (const uint8_t*)loop,
        (const int*)cursor_idx, (const int*)cursor_frac, (const int*)pitch_fp,
        n_src, frames, win_rows, (float*)out, (int*)mixed);
  }
  return (int)cudaGetLastError();
}
