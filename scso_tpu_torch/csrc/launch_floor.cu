// An empty kernel: the floor that one launch sets under every kernel's
// time (chip_smoke.py measures it beside K3 and K4). Not a port of any
// TPU kernel, and no path of the solver launches it.
#include "common.cuh"

namespace {

// one unused argument: cudaLaunchKernelEx builds an array of the
// arguments, which must not be empty
__global__ void empty_kernel(int) {}

}  // namespace

// ``blocks`` blocks of 32 threads; with ``cluster`` > 0 one launch of
// clusters of that many blocks through cudaLaunchKernelEx, as K3 and K4
// launch theirs
extern "C" int scso_empty_kernel(int64_t blocks, int64_t cluster,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || cluster < 0 || (cluster > 0 && blocks % cluster != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0) {
    empty_kernel<<<static_cast<unsigned>(blocks), 32, 0, s>>>(0);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t allowed = scso::allow_cluster(empty_kernel, 0);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  scso::ClusterLaunch l(static_cast<unsigned>(cluster), 32, 0, s);
  l.cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, empty_kernel, 0));
}
