// Fused mode-A frame path: lookahead delay line, end-of-stream fade,
// signal mask, coefficient-ramped highshelf biquad, peak and the new
// lookahead tail, for every (source, ear) lane.
//
// Replaces godot_audio_spatializer_tpu/ops/pallas/mix_kernel.py:
// fused_mode_a (_mix_a_kernel) and fused_mode_a_planar
// (_mix_a_planar_kernel).  Both are one kernel here, templated on the
// input indexing: interleaved frames [N, F, 2], or the resampler's raw
// planar layout [2, F/128, Np, 128].  The TPU kernels pack lanes into
// [8, 128] vector tiles and pick a fade-free loop body per tile from a
// flag computed in XLA; on Hopper each lane is one thread and branches
// on its own `mixed < F`.
//
// What bounds it on the card: the recurrence, then the bytes.  It moves
// ~38 MB at N=4096, F=512 (frames in, signal out, lookahead in and out),
// ~11 us at 3.35 TB/s; but only 2N = 8192 lanes carry a 512-step
// dependent chain, which is ~2 warps per SM, so latency and not
// bandwidth sets the time.  Design: the state (x1, x2, y1, y2, fade
// counter, peak) stays in registers, the frame reads do not depend on
// the recurrence so the unrolled loop issues them ahead, and a warp's
// reads at one frame fall in a few cache lines that the following
// frames reuse from L1.
//
// Arithmetic follows _mix_loop_and_state exactly: coefficients are
// evaluated affinely, c0 + (f+1)*inc, at every frame (never
// accumulated); the mask multiplies the input, never the b
// coefficients; -fmad=false keeps every product and sum rounded on its
// own, as in the plain PyTorch twin (ops/kernels/mix_mode_a.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLA = 64;
constexpr float kFadeBase = 0.96f;
constexpr int kThreads = 64;  // 2N = 8192 lanes -> 128 blocks, one per SM

template <bool kPlanar>
__device__ __forceinline__ float read_frame(const float* __restrict__ x, int n,
                                            int e, int j, int frames, int np) {
  if (kPlanar) {
    const int nch = frames >> 7;
    return x[((size_t)(e * nch + (j >> 7)) * np + n) * 128 + (j & 127)];
  }
  return x[((size_t)n * frames + j) * 2 + e];
}

template <bool kPlanar>
__global__ void __launch_bounds__(kThreads)
mix_mode_a_kernel(const float* __restrict__ x, int np,
                  const float* __restrict__ la, const float* __restrict__ c0,
                  const float* __restrict__ inc, const float* __restrict__ st,
                  const int* __restrict__ mixed,
                  const uint8_t* __restrict__ mask, int n_src, int frames,
                  float* __restrict__ sig, float* __restrict__ la_out,
                  float* __restrict__ st_out, float* __restrict__ co_out,
                  float* __restrict__ peak_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n_src) return;
  // planar: a warp holds 32 consecutive sources of one ear, so its reads
  // share the 128-frame rows of one channel plane
  const int n = kPlanar ? t % n_src : t >> 1;
  const int e = kPlanar ? t / n_src : t & 1;

  const float cc0 = c0[n * 5 + 0], cc1 = c0[n * 5 + 1], cc2 = c0[n * 5 + 2],
              cc3 = c0[n * 5 + 3], cc4 = c0[n * 5 + 4];
  const float i0 = inc[n * 5 + 0], i1 = inc[n * 5 + 1], i2 = inc[n * 5 + 2],
              i3 = inc[n * 5 + 3], i4 = inc[n * 5 + 4];
  const int mixed_n = mixed[n];
  const float mf = (float)mixed_n;
  const float zms = mask[n] ? 1.0f : 0.0f;
  const float zm_over_la = zms * (1.0f / kLA);
  const bool fade = mixed_n < frames;
  const float* lan = la + (size_t)n * kLA * 2 + e;
  float* sign = sig + (size_t)n * frames * 2 + e;

  float x1 = st[(n * 2 + e) * 4 + 0], x2 = st[(n * 2 + e) * 4 + 1];
  float y1 = st[(n * 2 + e) * 4 + 2], y2 = st[(n * 2 + e) * 4 + 3];
  float fadec = 1.0f, peak = 0.0f;

#pragma unroll 8
  for (int f = 0; f < frames; ++f) {
    const float xin = f < kLA ? lan[f * 2]
                              : read_frame<kPlanar>(x, n, e, f - kLA, frames, np);
    float factor = zms;
    if (fade) {
      const float k = (float)f - mf;
      const bool in_fade = k >= 0.0f && k < (float)kLA;
      if (in_fade) fadec = fadec * kFadeBase;
      factor = k < 0.0f ? zms
                        : (in_fade ? (fadec * ((float)kLA - k)) * zm_over_la : 0.0f);
    }
    const float xt = xin * factor;
    const float kf = 1.0f + (float)f;
    const float yf = (cc0 + kf * i0) * xt + (cc1 + kf * i1) * x1 +
                     (cc2 + kf * i2) * x2 + (cc3 + kf * i3) * y1 +
                     (cc4 + kf * i4) * y2;
    sign[(size_t)f * 2] = yf;
    peak = fmaxf(peak, fabsf(yf));
    x2 = x1;
    x1 = xt;
    y2 = y1;
    y1 = yf;
  }

  const int s = (n * 2 + e) * 4;
  st_out[s + 0] = x1;
  st_out[s + 1] = x2;
  st_out[s + 2] = y1;
  st_out[s + 3] = y2;
  if (e == 0) {
    const float ff = (float)frames;
    co_out[n * 5 + 0] = cc0 + ff * i0;
    co_out[n * 5 + 1] = cc1 + ff * i1;
    co_out[n * 5 + 2] = cc2 + ff * i2;
    co_out[n * 5 + 3] = cc3 + ff * i3;
    co_out[n * 5 + 4] = cc4 + ff * i4;
  }
  peak_out[n * 2 + e] = peak;
  // lookahead tail: full-mix masked-in lanes keep the last LA stream frames
  const bool full = mixed_n >= frames && zms > 0.0f;
  float* lao = la_out + (size_t)n * kLA * 2 + e;
  for (int j = 0; j < kLA; ++j)
    lao[j * 2] = full ? read_frame<kPlanar>(x, n, e, frames - kLA + j, frames, np)
                      : lan[j * 2];
}

}  // namespace

extern "C" int gas_mix_mode_a(const void* x, int planar, int np,
                              const void* la, const void* c0, const void* inc,
                              const void* st, const void* mixed,
                              const void* mask, int n_src, int frames,
                              void* sig, void* la_out, void* st_out,
                              void* co_out, void* peak_out, void* stream) {
  if (n_src <= 0) return 0;
  const int lanes = 2 * n_src;
  dim3 grid((lanes + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar) {
    mix_mode_a_kernel<true><<<grid, block, 0, s>>>(
        (const float*)x, np, (const float*)la, (const float*)c0,
        (const float*)inc, (const float*)st, (const int*)mixed,
        (const uint8_t*)mask, n_src, frames, (float*)sig, (float*)la_out,
        (float*)st_out, (float*)co_out, (float*)peak_out);
  } else {
    mix_mode_a_kernel<false><<<grid, block, 0, s>>>(
        (const float*)x, np, (const float*)la, (const float*)c0,
        (const float*)inc, (const float*)st, (const int*)mixed,
        (const uint8_t*)mask, n_src, frames, (float*)sig, (float*)la_out,
        (float*)st_out, (float*)co_out, (float*)peak_out);
  }
  return (int)cudaGetLastError();
}
