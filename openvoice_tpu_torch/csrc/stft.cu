// K5: magnitude STFT: one warp per frame as a four-step FFT (n_fft 512, 1024
// and 2048), and a direct DFT for every other n_fft.
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
// Design, n_fft = R1 x R2 with R1 = 32 (the lanes of a warp) and R2 = 16, 32
// or 64 (n_fft 512, 1024, 2048), n = n1 + 32 n2, f = k2 + R2 k1:
//   1. lane n1 loads x[n1 + 32 n2] * w[n1 + 32 n2] for n2 = 0..R2-1: each n2
//      is one 128-byte read of the warp;
//   2. lane n1: Y[k2] = sum_n2 x[n1 + 32 n2] W_R2^(n2 k2), an R2-point FFT in
//      registers;
//   3. lane n1: Z[n1][k2] = Y[k2] W_N^(n1 k2);
//   4. the warp transposes Z through shared memory (one R2 x 33 float tile a
//      warp, real part then imaginary part), so that lane l holds the columns
//      k2 = l + 32 c (c < R2 / 32; at R2 = 16 lanes 16..31 hold none);
//   5. for each of its columns: X[k2 + R2 k1] = sum_n1 Z[n1][k2] W_32^(n1 k1),
//      a 32-point FFT;
//   6. for k1 = 0..15 the lanes write bins k2 + R2 k1, coalesced; the lane of
//      column 0 writes bin n_fft/2.
// Only __syncwarp orders the exchange: warps never wait on each other.  The
// window, the per-lane twiddles W_N^(n1 k2) and the small FFTs' roots come
// from the host, computed in float64 and rounded once to float32; the
// per-lane ones are read through the read-only cache, the roots, the same on
// every lane, are kernel parameters.  At R2 = 64 a lane holds 64 complex
// values in each step (128 floats); ptxas reports each instance's registers
// and spills at build time.
//
// Every other n_fft (any n_fft >= 2, hop >= 1, win <= n_fft: what the JAX
// package computes through its Pallas kernel or its XLA basis product) goes
// to stft_dft_kernel, the function as the Pallas kernel computes it, a sum
// over the frame per bin, without its basis matrix:
//   X[f] = sum_n x[n] w[n] W_N^((n f) mod N),  W_N^j = exp(-2 pi i j / N)
// A block takes DFT_FRAMES frames and DFT_THREADS bins, one bin a thread.
// The table of W_N^j, j < N, computed on the host in float64 and rounded
// once to float32, is staged in shared memory when it fits (N <= 28032) and
// read through the read-only cache otherwise.  The windowed frames are
// staged DFT_CHUNK samples at a time, [sample][frame], so that a thread reads
// one sample of all its frames as two 16-byte broadcasts; each thread sums
// its bin over a chunk into a partial sum and adds that to the total, which
// keeps the f32 rounding of a 4096-term sum near that of a 256-term one.  The
// table index (n f) mod N advances by f a sample and wraps once: integer
// exact.  It costs N (N/2 + 1) complex multiply-adds a frame against the
// FFT's 2.5 N log2 N, so it is for the sizes the FFT instances do not take.

#include <cuda_runtime.h>

namespace {

constexpr int R1 = 32;     // lanes of a warp: step 2 runs R1 FFTs, step 5 FFTs of R1 points
constexpr int MAX_R = 64;  // the largest radix of an instance

// exp(-2 pi i j / M), j = 0..M/2-1, M = max(R1, R2): the roots of every small
// FFT of an instance (W_R^e = W_M^(e M / R))
struct Roots {
    float re[MAX_R / 2], im[MAX_R / 2];
};

template <int R2>
struct Instance {
    static constexpr int N = R1 * R2;
    static constexpr int M = R2 > R1 ? R2 : R1;
    static constexpr int COLS = (R2 + R1 - 1) / R1;  // step-5 columns a lane
    static constexpr int WARPS = R2 > 32 ? 4 : 8;    // frames a block: at most 33.8 KB of tiles
};

__device__ __forceinline__ constexpr int bit_reverse(int i, int n) {
    int r = 0;
    for (int m = n >> 1; m; m >>= 1, i >>= 1) r = (r << 1) | (i & 1);
    return r;
}

// One radix-2 stage of an N-point FFT: butterflies of span HALF.
template <int N, int M, int HALF>
__device__ __forceinline__ void fft_stage(float (&re)[N], float (&im)[N], const Roots& w) {
#pragma unroll
    for (int base = 0; base < N; base += 2 * HALF) {
#pragma unroll
        for (int j = 0; j < HALF; ++j) {
            const int e = j * (M / 2 / HALF);  // W_{2 HALF}^j = W_M^e
            const int p = base + j, q = p + HALF;
            const float tr = re[q] * w.re[e] - im[q] * w.im[e];
            const float ti = re[q] * w.im[e] + im[q] * w.re[e];
            re[q] = re[p] - tr;
            im[q] = im[p] - ti;
            re[p] += tr;
            im[p] += ti;
        }
    }
    if constexpr (2 * HALF < N) fft_stage<N, M, 2 * HALF>(re, im, w);
}

// In-place N-point forward DFT of (re, im) in registers, natural order in
// and out: a radix-2 decimation in time whose every index is a compile-time
// constant, so the arrays stay in registers.
template <int N, int M>
__device__ __forceinline__ void fft(float (&re)[N], float (&im)[N], const Roots& w) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int j = bit_reverse(i, N);
        if (i < j) {
            const float r = re[i], m = im[i];
            re[i] = re[j]; im[i] = im[j];
            re[j] = r; im[j] = m;
        }
    }
    fft_stage<N, M, 1>(re, im, w);
}

template <int R2>
__global__ void __launch_bounds__(Instance<R2>::WARPS * 32)
stft_fft_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                const float2* __restrict__ twiddle, float* __restrict__ out, int length,
                int frames, int hop, Roots roots) {
    using I = Instance<R2>;
    __shared__ float exchange[I::WARPS][R2][R1 + 1];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = blockIdx.x * I::WARPS + warp;
    if (t >= frames) return;  // the whole warp leaves; no barrier follows
    const int b = blockIdx.y;
    const float* a = audio + static_cast<long long>(b) * length + static_cast<long long>(t) * hop + lane;

    float re[R2], im[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
        re[n2] = __ldg(a + R1 * n2) * __ldg(window + lane + R1 * n2);
        im[n2] = 0.f;
    }
    fft<R2, I::M>(re, im, roots);
    // twiddle is [k2][n1]: the lanes of a warp read one contiguous line
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) {
        const float2 tw = __ldg(twiddle + k2 * R1 + lane);
        const float r = re[k2] * tw.x - im[k2] * tw.y;
        im[k2] = re[k2] * tw.y + im[k2] * tw.x;
        re[k2] = r;
    }
    // lane n1 writes row k2, column n1; the lane of column k2 then reads its
    // row.  The row stride of 33 words keeps both free of bank conflicts.
    float (*x)[R1 + 1] = exchange[warp];
    float zr[I::COLS][R1], zi[I::COLS][R1];
    auto has = [&](int c) { return R2 % R1 == 0 || lane + R1 * c < R2; };
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) x[k2][lane] = re[k2];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < I::COLS; ++c)
        if (has(c)) {
#pragma unroll
            for (int n1 = 0; n1 < R1; ++n1) zr[c][n1] = x[lane + R1 * c][n1];
        }
    __syncwarp();
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) x[k2][lane] = im[k2];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < I::COLS; ++c)
        if (has(c)) {
#pragma unroll
            for (int n1 = 0; n1 < R1; ++n1) zi[c][n1] = x[lane + R1 * c][n1];
        }

    float* o = out + (static_cast<long long>(b) * frames + t) * (I::N / 2 + 1);
#pragma unroll
    for (int c = 0; c < I::COLS; ++c) {
        if (!has(c)) continue;
        fft<R1, I::M>(zr[c], zi[c], roots);
        const int k2 = lane + R1 * c;
#pragma unroll
        for (int k1 = 0; k1 < R1 / 2; ++k1)
            o[k2 + R2 * k1] = sqrtf(zr[c][k1] * zr[c][k1] + zi[c][k1] * zi[c][k1] + 1e-6f);
        if (k2 == 0)
            o[I::N / 2] = sqrtf(zr[c][R1 / 2] * zr[c][R1 / 2] + zi[c][R1 / 2] * zi[c][R1 / 2] + 1e-6f);
    }
}

constexpr int DFT_THREADS = 256;  // bins a block, one a thread
constexpr int DFT_FRAMES = 8;     // frames a block
constexpr int DFT_CHUNK = 256;    // samples of each frame staged at a time
constexpr int SMEM_MAX = 232448;  // shared memory a block may ask for on sm_90
constexpr int DFT_FRAMES_BYTES = DFT_CHUNK * DFT_FRAMES * 4;  // the staged chunk, [DFT_CHUNK][DFT_FRAMES]

// STAGED: the table sits in shared memory after the frames' chunk.
template <bool STAGED>
__global__ void __launch_bounds__(DFT_THREADS)
stft_dft_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                const float2* __restrict__ table, float* __restrict__ out, int length, int frames,
                int n_fft, int hop) {
    extern __shared__ __align__(16) float dsm[];
    float (*xs)[DFT_FRAMES] = reinterpret_cast<float (*)[DFT_FRAMES]>(dsm);  // [DFT_CHUNK][DFT_FRAMES]
    float2* staged = reinterpret_cast<float2*>(dsm + DFT_CHUNK * DFT_FRAMES);
    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * DFT_FRAMES;
    const int f = blockIdx.y * DFT_THREADS + tid;
    const int b = blockIdx.z;
    const int n_freq = n_fft / 2 + 1;
    const bool has_bin = f < n_freq;  // the others stage samples and pass the barriers
    const float* a = audio + static_cast<long long>(b) * length;

    if (STAGED)
        for (int i = tid; i < n_fft; i += DFT_THREADS) staged[i] = table[i];
    const float2* tab = STAGED ? staged : table;

    float re[DFT_FRAMES], im[DFT_FRAMES];
#pragma unroll
    for (int j = 0; j < DFT_FRAMES; ++j) re[j] = im[j] = 0.f;
    for (int n0 = 0; n0 < n_fft; n0 += DFT_CHUNK) {
        const int cn = min(DFT_CHUNK, n_fft - n0);
        __syncthreads();  // the last chunk is read
        // consecutive threads read consecutive samples of one frame
        for (int i = tid; i < cn * DFT_FRAMES; i += DFT_THREADS) {
            const int j = i / cn, n = i - j * cn;
            const int t = t0 + j;
            xs[n][j] = t < frames ? a[static_cast<long long>(t) * hop + n0 + n] * window[n0 + n] : 0.f;
        }
        __syncthreads();  // the chunk (and the table) is staged
        if (!has_bin) continue;
        int idx = static_cast<int>(static_cast<long long>(n0) * f % n_fft);
        float pr[DFT_FRAMES], pi[DFT_FRAMES];
#pragma unroll
        for (int j = 0; j < DFT_FRAMES; ++j) pr[j] = pi[j] = 0.f;
        for (int n = 0; n < cn; ++n) {
            const float2 w = STAGED ? tab[idx] : __ldg(tab + idx);
            const float4 x0 = *reinterpret_cast<const float4*>(&xs[n][0]);
            const float4 x1 = *reinterpret_cast<const float4*>(&xs[n][4]);
            const float x[DFT_FRAMES] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int j = 0; j < DFT_FRAMES; ++j) {
                pr[j] = fmaf(x[j], w.x, pr[j]);
                pi[j] = fmaf(x[j], w.y, pi[j]);
            }
            idx += f;
            if (idx >= n_fft) idx -= n_fft;
        }
#pragma unroll
        for (int j = 0; j < DFT_FRAMES; ++j) {
            re[j] += pr[j];
            im[j] += pi[j];
        }
    }
    if (!has_bin) return;
#pragma unroll
    for (int j = 0; j < DFT_FRAMES; ++j) {
        const int t = t0 + j;
        if (t < frames)
            out[(static_cast<long long>(b) * frames + t) * n_freq + f] =
                sqrtf(re[j] * re[j] + im[j] * im[j] + 1e-6f);
    }
}

template <bool STAGED>
cudaError_t launch_dft(const float* audio, const float* window, const float* table, float* out, int batch,
                       int length, int frames, int n_fft, int hop, cudaStream_t stream) {
    const int smem = DFT_FRAMES_BYTES + (STAGED ? n_fft * 8 : 0);
    cudaError_t err =
        cudaFuncSetAttribute(stft_dft_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((frames + DFT_FRAMES - 1) / DFT_FRAMES, (n_fft / 2 + DFT_THREADS) / DFT_THREADS, batch);
    stft_dft_kernel<STAGED><<<grid, DFT_THREADS, smem, stream>>>(
        audio, window, reinterpret_cast<const float2*>(table), out, length, frames, n_fft, hop);
    return cudaGetLastError();
}

template <int R2>
cudaError_t launch(const float* audio, const float* window, const float* twiddle, float* out, int batch,
                   int length, int frames, int hop, const Roots& roots, cudaStream_t stream) {
    constexpr int warps = Instance<R2>::WARPS;
    const dim3 grid((frames + warps - 1) / warps, batch);
    stft_fft_kernel<R2><<<grid, warps * 32, 0, stream>>>(
        audio, window, reinterpret_cast<const float2*>(twiddle), out, length, frames, hop, roots);
    return cudaGetLastError();
}

}  // namespace

// audio [batch, length], window [n_fft], twiddle [R2][32] complex (k2, n1) =
// exp(-2 pi i n1 k2 / n_fft) and out [batch, frames, n_fft/2 + 1] are
// contiguous float32 on `device`, n_fft = 32 R2 with R2 in {16, 32, 64};
// roots (host memory) holds exp(-2 pi i j / M) for j = 0..M/2-1, M = max(32,
// R2), as M/2 real parts, then M/2 imaginary parts.  The launch goes on
// `stream`.  Returns the CUDA error of the launch (0 on success), -1 for an
// n_fft without an instance.
extern "C" int stft_magnitude_f32(const float* audio, const float* window, const float* twiddle,
                                  const float* roots, float* out, int batch, int length, int frames,
                                  int n_fft, int hop, int device, void* stream) {
    const int r2 = n_fft / R1;
    if (n_fft % R1 || (r2 != 16 && r2 != 32 && r2 != 64)) return -1;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int half = (r2 > R1 ? r2 : R1) / 2;
    Roots w;
    for (int j = 0; j < MAX_R / 2; ++j) {
        w.re[j] = j < half ? roots[j] : 0.f;
        w.im[j] = j < half ? roots[half + j] : 0.f;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (r2) {
        case 16: err = launch<16>(audio, window, twiddle, out, batch, length, frames, hop, w, s); break;
        case 32: err = launch<32>(audio, window, twiddle, out, batch, length, frames, hop, w, s); break;
        default: err = launch<64>(audio, window, twiddle, out, batch, length, frames, hop, w, s); break;
    }
    return static_cast<int>(err);
}

// audio [batch, length], window [n_fft], table [n_fft] complex (re, im) =
// exp(-2 pi i j / n_fft) and out [batch, frames, n_fft/2 + 1] are contiguous
// float32 on `device`; any n_fft >= 2 with (n_fft/2 + 1) / 256 + 1 <= 65535
// bin groups, any hop >= 1, (frames - 1) * hop + n_fft <= length.  The launch
// goes on `stream`.  Returns the CUDA error of the launch (0 on success).
extern "C" int stft_dft_f32(const float* audio, const float* window, const float* table, float* out, int batch,
                            int length, int frames, int n_fft, int hop, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (DFT_FRAMES_BYTES + static_cast<long long>(n_fft) * 8 <= SMEM_MAX)
        err = launch_dft<true>(audio, window, table, out, batch, length, frames, n_fft, hop, s);
    else
        err = launch_dft<false>(audio, window, table, out, batch, length, frames, n_fft, hop, s);
    return static_cast<int>(err);
}
