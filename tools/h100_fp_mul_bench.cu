// The curve kernels' Fp product on one NVIDIA GPU at each unrolling of its
// outer loop: what the form costs in a thread's chain of dependent
// products, inside the point formulas (a doubling of 7 products, an
// addition of 16), in a windowed scalar multiplication (one thread: 15
// table entries, then 64 windows of 4 doublings and an addition, as
// g1_scalar_mul runs), in additions over 2^18 threads (16 each, as
// g1_msm's threads run them) and in products over 2^20 threads.  Every form
// is the header's own code (fp_mul<U>, pt_double<U>, pt_add<U> of
// csrc/g1_arith.cuh; U steps a pass of the loop, U = 12 fully unrolled);
// the kernels take U = MUL_UNROLL.  Each form is checked against that one.
// From the root of the repository:
//
//     mkdir -p .cuda_build && nvcc -gencode arch=compute_90a,code=sm_90a \
//         -std=c++17 -O3 -o .cuda_build/fp_mul_bench \
//         tools/h100_fp_mul_bench.cu && .cuda_build/fp_mul_bench

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

#include "../zkcnn_tpu_torch/csrc/g1_arith.cuh"

using namespace g1;

template <int U>
__global__ void chain_k(const u32* a, const u32* b, u32* out, int iters,
                        int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u32 x[NP], y[NP];
  for (int k = 0; k < NP; ++k) {
    x[k] = a[i * NP + k];
    y[k] = b[i * NP + k];
  }
  for (int s = 0; s < iters; ++s) fp_mul<U>(x, x, y);
  for (int k = 0; k < NP; ++k) out[i * NP + k] = x[k];
}

template <int U>
__global__ void point_k(const u32* p, u32* out, int iters, int adding) {
  Pt q, b;
  pt_load(&q, p);
  pt_load(&b, p + PW);
  for (int s = 0; s < iters; ++s) {
    if (adding)
      pt_add<U>(&q, &q, &b);
    else
      pt_double<U>(&q, &q);
  }
  pt_store(out, &q);
}

// k P by 4-bit windows in one thread, on form U's formulas: 15 table
// entries, then 64 windows of 4 doublings and one addition (no digit is
// zero here)
template <int U>
__global__ void window_k(const u32* p, u32* out) {
  Pt tab[15], acc;
  pt_load(&tab[0], p);
  for (int d = 2; d <= 15; ++d) {
    if (d & 1)
      pt_add<U>(&tab[d - 1], &tab[d - 2], &tab[0]);
    else
      pt_double<U>(&tab[d - 1], &tab[d / 2 - 1]);
  }
  pt_copy(&acc, &tab[14]);
  for (int w = 0; w < 64; ++w) {
    for (int s = 0; s < 4; ++s) pt_double<U>(&acc, &acc);
    pt_add<U>(&acc, &acc, &tab[(w * 7) % 15]);
  }
  pt_store(out, &acc);
}

// n threads, 16 additions each of points read from memory
template <int U>
__global__ void sum_k(const u32* pts, u32* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt acc, e;
  pt_load(&acc, pts + (size_t)(i % 4096) * PW);
  for (int s = 1; s <= 16; ++s) {
    pt_load(&e, pts + (size_t)((i + 97 * s) % 4096) * PW);
    pt_add<U>(&acc, &acc, &e);
  }
  pt_store(out + (size_t)i * PW, &acc);
}

#define CK(x)                                                         \
  do {                                                                \
    cudaError_t err_ = (x);                                           \
    if (err_) {                                                       \
      printf("CUDA error %s at line %d\n", cudaGetErrorString(err_),  \
             __LINE__);                                               \
      exit(1);                                                        \
    }                                                                 \
  } while (0)

// ms a launch, the mean of 3 after one warm-up
template <typename F>
float time_ms(F f) {
  cudaEvent_t s, e;
  CK(cudaEventCreate(&s));
  CK(cudaEventCreate(&e));
  f();
  CK(cudaDeviceSynchronize());
  CK(cudaEventRecord(s));
  for (int k = 0; k < 3; ++k) f();
  CK(cudaEventRecord(e));
  CK(cudaEventSynchronize(e));
  float ms;
  CK(cudaEventElapsedTime(&ms, s, e));
  CK(cudaGetLastError());
  return ms / 3;
}

template <int U>
void run(const char* name, u32* a, u32* b, u32* o, u32* o2, u32* pt,
         u32* ref) {
  const int c1 = 2000, c2 = 20000, n = 1 << 20;
  const float t1 = time_ms([&] { chain_k<U><<<1, 1>>>(a, b, o, c1, 1); });
  const float t2 = time_ms([&] { chain_k<U><<<1, 1>>>(a, b, o, c2, 1); });
  const float tt =
      time_ms([&] { chain_k<U><<<n / 128, 128>>>(a, b, o2, 16, n); });
  float pts[2];
  for (int adding = 0; adding < 2; ++adding) {
    const float p1 = time_ms([&] { point_k<U><<<1, 1>>>(pt, o, 20, adding); });
    const float p2 = time_ms([&] { point_k<U><<<1, 1>>>(pt, o, 270, adding); });
    pts[adding] = (p2 - p1) / 250 * 1e6f / (adding ? 16 : 7);
  }
  const float tw = time_ms([&] { window_k<U><<<1, 1>>>(pt, o); });
  const int ns = 1 << 18;
  const float ts = time_ms([&] { sum_k<U><<<ns / 64, 64>>>(o2, ref, ns); });
  static u32 h[NP * 64], hr[NP * 64];
  chain_k<U><<<1, 64>>>(a, b, o, 777, 64);
  CK(cudaMemcpy(h, o, sizeof(h), cudaMemcpyDeviceToHost));
  chain_k<MUL_UNROLL><<<1, 64>>>(a, b, ref, 777, 64);
  CK(cudaMemcpy(hr, ref, sizeof(hr), cudaMemcpyDeviceToHost));
  int same = 1;
  for (int k = 0; k < NP * 64; ++k) same &= h[k] == hr[k];
  printf("%-6s dependent product %7.1f ns; in a doubling %7.1f ns and in an "
         "addition %7.1f ns a product; windowed scalar mul %.4f ms; "
         "additions over 2^18 threads %.4f ns each; products over 2^20 "
         "threads %.4f ns each; equal to U = MUL_UNROLL: %s\n",
         name, (t2 - t1) / (c2 - c1) * 1e6f, pts[0], pts[1], tw,
         ts / (16.0f * ns) * 1e6f, tt / (16.0f * n) * 1e6f,
         same ? "yes" : "NO");
  if (!same) exit(1);
}

int main() {
  const int n = 1 << 20;
  u32 *a, *b, *o, *o2, *pt, *ref;
  CK(cudaMalloc(&a, n * NP * 4));
  CK(cudaMalloc(&b, n * NP * 4));
  CK(cudaMalloc(&o, n * NP * 4));
  CK(cudaMalloc(&o2, n * NP * 4));
  CK(cudaMalloc(&ref, n * NP * 4));
  CK(cudaMalloc(&pt, 2 * PW * 4));
  // words below p (top word under 2^16); the points are random words, on
  // which the formulas' edge cases (Z = 0, equal x) do not arise
  u32* h = (u32*)malloc((size_t)n * NP * 4);
  unsigned s = 12345;
  for (int pass = 0; pass < 2; ++pass) {
    for (long k = 0; k < (long)n * NP; ++k) {
      s = s * 1103515245u + 12345u;
      h[k] = (k % NP == NP - 1) ? (s & 0xffff) : s;
    }
    CK(cudaMemcpy(pass ? b : a, h, (size_t)n * NP * 4,
                  cudaMemcpyHostToDevice));
  }
  CK(cudaMemcpy(pt, h, 2 * PW * 4, cudaMemcpyHostToDevice));
  run<1>("U = 1", a, b, o, o2, pt, ref);
  run<2>("U = 2", a, b, o, o2, pt, ref);
  run<3>("U = 3", a, b, o, o2, pt, ref);
  run<4>("U = 4", a, b, o, o2, pt, ref);
  run<6>("U = 6", a, b, o, o2, pt, ref);
  run<12>("U = 12", a, b, o, o2, pt, ref);
  return 0;
}
