// clock64 phase split of G6's trips (csrc/dis_ref.cu), for
// probes/ref_times.py --phases.  Built as its own shared library: the
// kernel source (REF_SOURCE) is compiled with its REF_PHASE hooks
// defined, so every patch's warp adds the clock64 cycles between hooks
// to per-phase counters, which lane 0 writes to [patch, 16] int64 at
// fot_ref_phases_buffer's pointer: phases 0 blend (the window's loads
// and the blend), 1 the mean's butterfly, 2 the transform (and, where
// one pass does it, the projection partials), 3 the sums' butterfly, 4 a
// projection pass of its own with its butterflies (the first design), 5
// the step and test, 6 the window's address (where a hook marks it);
// then 7 the patch's samples, 8 and 9 %globaltimer (ns) at the warp's
// start and end, 10 its SM.  fot_dis_ref keeps the library's arguments.

#include <cstdint>
#include <cuda_runtime.h>

__device__ long long* g_ref_phases;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

#define REF_PHASES_BEGIN                             \
  const long long ph_start = global_ns();            \
  long long ph_t = clock64();                        \
  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define REF_PHASE(k)                                 \
  {                                                  \
    const long long ph_now = clock64();              \
    ph[k] += ph_now - ph_t;                          \
    ph_t = ph_now;                                   \
    if ((k) == 3) ph[7] += 1;                        \
  }
#define REF_PHASES_END                               \
  if (lane == 0) {                                   \
    long long* out = g_ref_phases + 16 * (int64_t)p; \
    for (int i = 0; i < 8; ++i) out[i] = ph[i];      \
    out[8] = ph_start;                               \
    out[9] = global_ns();                            \
    out[10] = sm_id();                               \
  }

#include REF_SOURCE

extern "C" int fot_ref_phases_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_ref_phases, &buf, sizeof(buf));
}
