// The rate of two mma.sync instructions on the card K2 was designed for:
// int8 m16n8k32 (s8 x s8 -> s32) and 1-bit m16n8k256 (b1, and.popc -> s32).
// K2 (../ibs.cu) takes its products with the second, which is only worth it
// if the card issues it as fast as the first at eight times the depth; the
// data sheet gives no 1-bit rate, so this measures both. Every SM runs four
// blocks of eight warps, each warp a loop of eight independent MMAs.
// It also checks the 1-bit fragment layout K2 relies on (that of the int8
// instruction with a byte read as eight bits; both from ../common.cuh)
// against popcounts on the host.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o mma_rate mma_rate.cu && ./mma_rate
// (from this directory; `ops/_kernels.run_bench('mma_rate')` does the same)
//
// Prints one line per instruction (milliseconds, G instructions/s,
// T operations/s, the best of three runs) and the layout check; exit code 1
// if a launch fails or the layout differs.

#include <cstdio>

#include "../common.cuh"

template <bool OneBit>
__global__ void rate_kernel(int iters, unsigned seed, int* out) {
  const unsigned a[4] = {seed + threadIdx.x, seed * 3 + threadIdx.x,
                         seed ^ threadIdx.x, seed + 7};
  const unsigned b0 = seed * 5 + threadIdx.x, b1 = seed * 11 + threadIdx.x;
  int acc[8][4];
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (OneBit) mma_b1(acc[j], a, b0 + j, b1);
      else mma_s8(acc[j], a, b0 + j, b1);
    }
  }
  int s = 0;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// one 16 x 8 tile of popcount(A row & B column) over 256 bits, with A
// (16 rows x 8 words) and B (8 columns x 8 words) fetched as ldmatrix would
__global__ void layout_kernel(const unsigned* A, const unsigned* B, int* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const unsigned a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + 4 + t],
                         A[(g + 8) * 8 + 4 + t]};
  int d[4] = {0, 0, 0, 0};
  mma_b1(d, a, B[g * 8 + t], B[g * 8 + 4 + t]);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * 4, threads = 256, iters = 20000;
  int* out;
  cudaMalloc(&out, (size_t)blocks * threads * sizeof(int));
  bool ok = true;
  for (int one_bit = 0; one_bit < 2; ++one_bit) {
    float best = 1e30f;
    for (int rep = 0; rep < 3; ++rep) {
      cudaEvent_t s, e;
      cudaEventCreate(&s);
      cudaEventCreate(&e);
      cudaEventRecord(s);
      if (one_bit) rate_kernel<true><<<blocks, threads>>>(iters, 12345u, out);
      else rate_kernel<false><<<blocks, threads>>>(iters, 12345u, out);
      cudaEventRecord(e);
      cudaEventSynchronize(e);
      float ms;
      cudaEventElapsedTime(&ms, s, e);
      if (ms < best) best = ms;
    }
    ok = ok && cudaGetLastError() == cudaSuccess;
    const double n_mma = (double)blocks * (threads / 32) * iters * 8;
    const double ops = n_mma * 16 * 8 * (one_bit ? 256 : 32) * 2;
    printf("%s: %.3f ms, %.1f G mma/s, %.1f T op/s\n",
           one_bit ? "b1 m16n8k256 and.popc" : "s8 m16n8k32", best,
           n_mma / best / 1e6, ops / best / 1e9);
  }
  unsigned hA[128], hB[64], x = 1;
  int hD[128];
  for (int i = 0; i < 128; ++i) hA[i] = x = x * 1664525u + 1013904223u;
  for (int i = 0; i < 64; ++i) hB[i] = x = x * 1664525u + 1013904223u;
  unsigned *dA, *dB;
  int* dD;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMalloc(&dD, sizeof hD);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_kernel<<<1, 32>>>(dA, dB, dD);
  cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 8; ++j) {
      int want = 0;
      for (int k = 0; k < 8; ++k)
        want += __builtin_popcount(hA[i * 8 + k] & hB[j * 8 + k]);
      bad += want != hD[i * 8 + j];
    }
  ok = ok && cudaGetLastError() == cudaSuccess && bad == 0;
  printf("b1 fragment layout: %d of 128 entries differ from the host's "
         "popcounts\n", bad);
  return ok ? 0 : 1;
}
