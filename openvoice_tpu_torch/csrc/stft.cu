// K5: magnitude STFT as one framed, windowed real-DFT product.
//
// Replaces the TPU kernel openvoice_tpu/ops/stft_pallas.py::stft_magnitude_pallas
// (body _stft_kernel).  For each batch row b, frame t and bin f:
//
//   re = sum_n audio[b, t*hop + n] * basis[n, f]
//   im = sum_n audio[b, t*hop + n] * basis[n, n_freq + f]
//   out[b, t, f] = sqrt(re*re + im*im + 1e-6)
//
// where basis is the windowed real-DFT basis of audio/stft.py::stft_basis
// (periodic Hann, zero-padded and centred when win < n_fft).  Frames are read
// straight from the reflect-padded audio and never written to device memory.
//
// What bounds it: at the converter's shape (n_fft 1024, hop 256, 1024 frames)
// it is 2.15 GFLOP against ~7 MB of traffic, ~300 FLOP per byte, so on an
// H100 it is bound by fp32 arithmetic, not by memory.  The 1e-4 parity bar
// rules out plain TF32 tensor cores, so the product stays in fp32 FMA.
//
// Design: one block of 256 threads computes a 64-frame x 64-bin tile of both
// re and im, as a register-blocked fp32 GEMM (4 frames x 4 bins x {re, im}
// per thread).  Each 16-tap step stages the tile's frame taps and basis rows
// in shared memory, so every audio sample and basis value a block reads from
// device memory is reused 4 (frames) or 16 (threads) times from shared
// memory.  Threads of a warp read consecutive bins and broadcast frames, so
// the shared-memory reads are free of bank conflicts.  The magnitude is taken
// in registers, and each output element is written once.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // frames per block
constexpr int BN = 64;   // frequency bins per block (each as re and im)
constexpr int BK = 16;   // DFT taps per shared-memory stage
constexpr int TM = 4;    // frames per thread
constexpr int TN = 4;    // bins per thread
constexpr int LANES_M = BM / TM;  // 16
constexpr int LANES_N = BN / TN;  // 16
constexpr int THREADS = LANES_M * LANES_N;  // 256

__global__ void __launch_bounds__(THREADS)
stft_magnitude_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                      float* __restrict__ out, int length, int frames, int n_fft, int hop,
                      int n_freq) {
    __shared__ float a_s[BK][BM + 1];
    __shared__ float re_s[BK][BN];
    __shared__ float im_s[BK][BN];

    const int b = blockIdx.z;
    const int t0 = blockIdx.y * BM;
    const int f0 = blockIdx.x * BN;
    const int tid = threadIdx.x;
    const int tx = tid % LANES_N;  // bin lane: bins f0 + tx + j * LANES_N
    const int ty = tid / LANES_N;  // frame lane: frames t0 + ty + i * LANES_M
    const float* a = audio + static_cast<long long>(b) * length;
    const long long row = 2LL * n_freq;

    float acc_re[TM][TN];
    float acc_im[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            acc_re[i][j] = 0.f;
            acc_im[i][j] = 0.f;
        }
    }

    for (int k0 = 0; k0 < n_fft; k0 += BK) {
        // frame t, tap k is audio[t * hop + k]: the frames are never built
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int m = i / BK, kk = i % BK;
            const int t = t0 + m, k = k0 + kk;
            a_s[kk][m] = (t < frames && k < n_fft) ? a[static_cast<long long>(t) * hop + k] : 0.f;
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int kk = i / BN, n = i % BN;
            const int k = k0 + kk, f = f0 + n;
            const bool ok = k < n_fft && f < n_freq;
            re_s[kk][n] = ok ? basis[k * row + f] : 0.f;
            im_s[kk][n] = ok ? basis[k * row + n_freq + f] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[TM], rv[TN], iv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = a_s[kk][ty + i * LANES_M];
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                rv[j] = re_s[kk][tx + j * LANES_N];
                iv[j] = im_s[kk][tx + j * LANES_N];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc_re[i][j] = fmaf(av[i], rv[j], acc_re[i][j]);
                    acc_im[i][j] = fmaf(av[i], iv[j], acc_im[i][j]);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int t = t0 + ty + i * LANES_M;
        if (t >= frames) continue;
        float* o = out + (static_cast<long long>(b) * frames + t) * n_freq;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int f = f0 + tx + j * LANES_N;
            if (f < n_freq) {
                const float re = acc_re[i][j], im = acc_im[i][j];
                o[f] = sqrtf(re * re + im * im + 1e-6f);
            }
        }
    }
}

}  // namespace

// audio [batch, length], basis [n_fft, 2 * n_freq] and out [batch, frames,
// n_freq] are contiguous float32 on `device`; the launch goes on `stream`.
// Returns the CUDA error of the launch (0 on success).
extern "C" int stft_magnitude_f32(const float* audio, const float* basis, float* out, int batch,
                                  int length, int frames, int n_fft, int hop, int n_freq,
                                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_freq + BN - 1) / BN, (frames + BM - 1) / BM, batch);
    stft_magnitude_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        audio, basis, out, length, frames, n_fft, hop, n_freq);
    return static_cast<int>(cudaGetLastError());
}
