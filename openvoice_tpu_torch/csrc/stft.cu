// K5: magnitude STFT, one warp per frame, as a four-step FFT.
//
// Replaces the TPU kernel openvoice_tpu/ops/stft_pallas.py::stft_magnitude_pallas
// (body _stft_kernel).  For each batch row b, frame t and bin f < n_fft/2 + 1:
//
//   X[f] = sum_n audio[b, t*hop + n] * w[n] * exp(-2 pi i n f / n_fft)
//   out[b, t, f] = sqrt(re*re + im*im + 1e-6)
//
// with w the window of audio/stft.py::stft_basis (periodic Hann, zero-padded
// and centred when win < n_fft).  Frames are read straight from the
// reflect-padded audio and never written to device memory.
//
// What bounds it: a 1024-point FFT is about 2.5 N log2 N = 26 kFLOP a frame,
// and the function moves the audio once in and the bins once out (at the
// converter's 1024 frames, 3.15 MB): about 1 us by bytes on an H100, less by
// operations.  So bytes bound it, and at 1024 frames what really sets its
// time is latency: one pass of loads, two FFTs in registers, one exchange
// between lanes and one pass of stores, in as few dependent steps as
// possible.  (The DFT as a product with a basis would be 2.15 GFLOP of fp32
// FMA, since the 1e-4 parity bar rules out TF32.)
//
// Design, n_fft = 1024 = 32 x 32, n = n1 + 32 n2, f = k2 + 32 k1:
//   1. lane n1 loads x[n1 + 32 n2] * w[n1 + 32 n2] for n2 = 0..31: each n2 is
//      one 128-byte read of the warp;
//   2. lane n1: Y[k2] = sum_n2 x[n1 + 32 n2] W32^(n2 k2), a 32-point FFT in
//      registers;
//   3. lane n1: Z[n1][k2] = Y[k2] W1024^(n1 k2);
//   4. the warp transposes Z through shared memory (one 32 x 33 float tile a
//      warp, real part then imaginary part), so lane k2 holds Z[.][k2];
//   5. lane k2: X[k2 + 32 k1] = sum_n1 Z[n1][k2] W32^(n1 k1), a second
//      32-point FFT;
//   6. for k1 = 0..15 the warp writes bins 32 k1 .. 32 k1 + 31, coalesced;
//      lane 0 writes bin 512.
// Only __syncwarp orders the exchange: warps never wait on each other.  The
// window, the per-lane twiddles W1024^(n1 k2) and the 32-point twiddles come
// from the host, computed in float64 and rounded once to float32; the
// per-lane ones are read through the read-only cache, the 32-point ones,
// the same on every lane, are kernel parameters.

#include <cuda_runtime.h>

namespace {

constexpr int RADIX = 32;              // n_fft = RADIX * RADIX
constexpr int N_FFT = RADIX * RADIX;
constexpr int N_FREQ = N_FFT / 2 + 1;  // 513
constexpr int WARPS = 8;               // frames a block

// exp(-2 pi i j / 32), j = 0..15
struct Twiddle32 {
    float re[RADIX / 2], im[RADIX / 2];
};

__device__ __forceinline__ constexpr int bit_reverse5(int i) {
    return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) | ((i & 16) >> 4);
}

// One radix-2 stage of fft32: butterflies of span HALF.
template <int HALF>
__device__ __forceinline__ void fft32_stage(float (&re)[RADIX], float (&im)[RADIX], const Twiddle32& w) {
#pragma unroll
    for (int base = 0; base < RADIX; base += 2 * HALF) {
#pragma unroll
        for (int j = 0; j < HALF; ++j) {
            const int e = j * (RADIX / 2 / HALF);  // W_{2 HALF}^j = W_32^e
            const int p = base + j, q = p + HALF;
            const float tr = re[q] * w.re[e] - im[q] * w.im[e];
            const float ti = re[q] * w.im[e] + im[q] * w.re[e];
            re[q] = re[p] - tr;
            im[q] = im[p] - ti;
            re[p] += tr;
            im[p] += ti;
        }
    }
}

// In-place 32-point forward DFT of (re, im) in registers, natural order in
// and out: a radix-2 decimation in time whose every index is a compile-time
// constant, so the arrays stay in registers.
__device__ __forceinline__ void fft32(float (&re)[RADIX], float (&im)[RADIX], const Twiddle32& w) {
#pragma unroll
    for (int i = 0; i < RADIX; ++i) {
        const int j = bit_reverse5(i);
        if (i < j) {
            const float r = re[i], m = im[i];
            re[i] = re[j]; im[i] = im[j];
            re[j] = r; im[j] = m;
        }
    }
    fft32_stage<1>(re, im, w);
    fft32_stage<2>(re, im, w);
    fft32_stage<4>(re, im, w);
    fft32_stage<8>(re, im, w);
    fft32_stage<16>(re, im, w);
}

__global__ void __launch_bounds__(WARPS * 32)
stft_fft1024_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                    const float2* __restrict__ twiddle, float* __restrict__ out, int length,
                    int frames, int hop, Twiddle32 w32) {
    __shared__ float exchange[WARPS][RADIX][RADIX + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = blockIdx.x * WARPS + warp;
    if (t >= frames) return;  // the whole warp leaves; no barrier follows
    const int b = blockIdx.y;
    const float* a = audio + static_cast<long long>(b) * length + static_cast<long long>(t) * hop + lane;

    float re[RADIX], im[RADIX];
#pragma unroll
    for (int n2 = 0; n2 < RADIX; ++n2) {
        re[n2] = __ldg(a + RADIX * n2) * __ldg(window + lane + RADIX * n2);
        im[n2] = 0.f;
    }
    fft32(re, im, w32);
    // twiddle is [k2][n1]: the lanes of a warp read one contiguous line
#pragma unroll
    for (int k2 = 0; k2 < RADIX; ++k2) {
        const float2 tw = __ldg(twiddle + k2 * RADIX + lane);
        const float r = re[k2] * tw.x - im[k2] * tw.y;
        im[k2] = re[k2] * tw.y + im[k2] * tw.x;
        re[k2] = r;
    }
    // lane n1 writes row k2, column n1; lane k2 then reads its row.  The row
    // stride of 33 words keeps both free of bank conflicts.
    float (*x)[RADIX + 1] = exchange[warp];
#pragma unroll
    for (int k2 = 0; k2 < RADIX; ++k2) x[k2][lane] = re[k2];
    __syncwarp();
#pragma unroll
    for (int n1 = 0; n1 < RADIX; ++n1) re[n1] = x[lane][n1];
    __syncwarp();
#pragma unroll
    for (int k2 = 0; k2 < RADIX; ++k2) x[k2][lane] = im[k2];
    __syncwarp();
#pragma unroll
    for (int n1 = 0; n1 < RADIX; ++n1) im[n1] = x[lane][n1];
    fft32(re, im, w32);

    float* o = out + (static_cast<long long>(b) * frames + t) * N_FREQ;
#pragma unroll
    for (int k1 = 0; k1 < RADIX / 2; ++k1)
        o[RADIX * k1 + lane] = sqrtf(re[k1] * re[k1] + im[k1] * im[k1] + 1e-6f);
    if (lane == 0) o[N_FFT / 2] = sqrtf(re[RADIX / 2] * re[RADIX / 2] + im[RADIX / 2] * im[RADIX / 2] + 1e-6f);
}

}  // namespace

// audio [batch, length], window [n_fft], twiddle [32][32] complex (k2, n1) =
// exp(-2 pi i n1 k2 / n_fft) and out [batch, frames, n_fft/2 + 1] are
// contiguous float32 on `device`; w32 (host memory) holds exp(-2 pi i j / 32)
// for j = 0..15 as 16 real parts, then 16 imaginary parts.  The launch goes on
// `stream`.  Returns the CUDA error of the launch (0 on success), -1 for an
// n_fft other than 1024.
extern "C" int stft_magnitude_f32(const float* audio, const float* window, const float* twiddle,
                                  const float* w32, float* out, int batch, int length, int frames,
                                  int n_fft, int hop, int device, void* stream) {
    if (n_fft != N_FFT) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Twiddle32 tw;
    for (int j = 0; j < RADIX / 2; ++j) {
        tw.re[j] = w32[j];
        tw.im[j] = w32[RADIX / 2 + j];
    }
    const dim3 grid((frames + WARPS - 1) / WARPS, batch);
    stft_fft1024_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        audio, window, reinterpret_cast<const float2*>(twiddle), out, length, frames, hop, tw);
    return static_cast<int>(cudaGetLastError());
}
