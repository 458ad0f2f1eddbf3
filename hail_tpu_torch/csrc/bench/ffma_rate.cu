// The rate at which the card issues f32 FFMAs outside the tensor cores, the
// rate under the operations of K1's bound (../linreg_f32.cu): the data
// sheet's 67 TFLOP/s is 132 SMs x 128 lanes x 2 at 1.98 GHz. Each warp runs
// a loop of 32 independent FFMA chains; the kernel is timed with K1's
// sixteen warps per SM (here two blocks of eight) and with eight blocks per
// SM, for about as long as one K1 launch and for a hundred times as long (a
// card that has not reached its clock yet shows in the short run only).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o ffma_rate ffma_rate.cu && ./ffma_rate
// (from this directory; `ops/_kernels.run_bench('ffma_rate')` does the same)
//
// Prints one line per case (milliseconds, T FFMA lane-operations/s counted
// as two flops, the best of three runs); exit code 1 if a launch fails.

#include <cstdio>

#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
ffma_kernel(int iters, float a, float b, float* out) {
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = threadIdx.x + j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = fmaf(acc[j], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int threads = 256;
  float* out;
  cudaMalloc(&out, (size_t)sms * 8 * threads * sizeof(float));
  bool ok = true;
  for (int per_sm = 2; per_sm <= 8; per_sm *= 4) {
    for (int iters = 400 / per_sm; iters <= 40000 / per_sm; iters *= 100) {
      const int blocks = sms * per_sm;
      float best = 1e30f;
      for (int rep = 0; rep < 3; ++rep) {
        cudaEvent_t s, e;
        cudaEventCreate(&s);
        cudaEventCreate(&e);
        cudaEventRecord(s);
        ffma_kernel<<<blocks, threads>>>(iters, 0.999f, 0.5f, out);
        cudaEventRecord(e);
        cudaEventSynchronize(e);
        float ms;
        cudaEventElapsedTime(&ms, s, e);
        if (ms < best) best = ms;
      }
      ok = ok && cudaGetLastError() == cudaSuccess;
      const double flops = 2.0 * blocks * threads * (double)iters * 32;
      printf("%d blocks of 256 per SM, %d x 32 FFMA a thread: %.4f ms, "
             "%.1f TFLOP/s\n", per_sm, iters, best, flops / best / 1e9);
    }
  }
  return ok ? 0 : 1;
}
