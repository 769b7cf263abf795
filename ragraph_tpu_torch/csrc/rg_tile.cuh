// Constants shared by the retrieval kernels (fused_retrieval.cu, probes.cu,
// bucket_topk.cu). Their scores all come from the tensor-core tile of
// rg_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rg {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.0e38f;

}  // namespace rg
