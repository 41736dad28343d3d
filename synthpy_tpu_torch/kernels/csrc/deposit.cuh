// The channel loop of a cloud-in-cell deposit, shared by K8 (deposit.cu)
// and K12 (cic.cu): V values of one ray, each times its corner weight,
// added atomically into the V channels of one node (in device memory, or
// in a block's shared copy of the image: K12's shared form). Both files
// are built with --fmad=false, so each product is rounded before its add.

#pragma once

#include <cuda_runtime.h>

namespace deposit {

template <int V>
__device__ __forceinline__ void add_weighted(float* node, const float v[V],
                                             float w) {
#pragma unroll
  for (int c = 0; c < V; ++c) atomicAdd(node + c, v[c] * w);
}

}  // namespace deposit
