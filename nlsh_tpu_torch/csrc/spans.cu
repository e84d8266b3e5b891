// Layer marks of a serve: one-thread kernels that split a serve's device
// time by layer on the card's own clock.  They replace no TPU kernel: the
// JAX package names a serve's layers only in a profiler's host trace.
//
// nlsh_tpu_torch/utils/profiling.py `mark` launches one on the current
// stream at each layer boundary of the serve bodies (hash, prep, score,
// merge, end); under a capture each becomes a kernel node of the graph,
// inside a conditional node's body too, so every replay runs it.  Each mark
// is an extern "C" kernel of its own, so a profiler's trace names it as
// written here: nlsh_span_hash, nlsh_span_prep, nlsh_span_score,
// nlsh_span_merge, nlsh_span_end, and the count-only nlsh_span_bound (the
// ensemble guard's static-bound branch).  A mark reads and writes a few
// int64 slots: its cost is its launch, not its work.
//
// `acc` is one device array of SPAN_SLOTS int64 (profiling.py mirrors the
// layout):
//   acc[0]          %globaltimer (ns) at the last boundary mark
//   acc[1]          the open layer: 0 none, 1 hash, 2 prep, 3 score, 4 merge
//   acc[2 + l]      ns spent in layer l + 1, l = 0..3
//   acc[6 + l]      times layer l + 1 was opened
//   acc[10]         nlsh_span_bound marks
// A boundary mark adds the time since the last mark to the open layer, then
// opens its own (nlsh_span_end opens none).  nlsh_span_hash starts a serve
// and charges nothing to a layer a serve left open.  Any other mark with no
// layer open (a serve body without a hash mark) does nothing, and a mark of
// the open layer continues it uncounted.  The marks of one stream run in
// order, so no two touch `acc` at once.
// nlsh_span launches the mark `which` (1 hash ... 5 end, 6 bound) on
// `stream` and returns its cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kLast = 0, kOpen = 1, kNs = 2, kCount = 6, kBound = 10;
constexpr long long kNone = 0, kHash = 1, kPrep = 2, kScore = 3, kMerge = 4,
                    kEnd = 5;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ void boundary(long long* acc, long long layer) {
  const long long now = global_ns();
  const long long open = acc[kOpen];
  if (layer == kHash) {
    acc[kCount] += 1;
  } else {
    if (open == kNone) return;
    acc[kNs + open - 1] += now - acc[kLast];
    if (layer != kEnd && layer != open) acc[kCount + layer - 1] += 1;
  }
  acc[kOpen] = layer == kEnd ? kNone : layer;
  acc[kLast] = now;
}

}  // namespace

extern "C" {

__global__ void nlsh_span_hash(long long* acc) { boundary(acc, kHash); }
__global__ void nlsh_span_prep(long long* acc) { boundary(acc, kPrep); }
__global__ void nlsh_span_score(long long* acc) { boundary(acc, kScore); }
__global__ void nlsh_span_merge(long long* acc) { boundary(acc, kMerge); }
__global__ void nlsh_span_end(long long* acc) { boundary(acc, kEnd); }
__global__ void nlsh_span_bound(long long* acc) { acc[kBound] += 1; }

int nlsh_span(int which, long long* acc, cudaStream_t stream) {
  switch (which) {
    case 1: nlsh_span_hash<<<1, 1, 0, stream>>>(acc); break;
    case 2: nlsh_span_prep<<<1, 1, 0, stream>>>(acc); break;
    case 3: nlsh_span_score<<<1, 1, 0, stream>>>(acc); break;
    case 4: nlsh_span_merge<<<1, 1, 0, stream>>>(acc); break;
    case 5: nlsh_span_end<<<1, 1, 0, stream>>>(acc); break;
    case 6: nlsh_span_bound<<<1, 1, 0, stream>>>(acc); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
