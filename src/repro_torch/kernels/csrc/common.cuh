// The activation every GNN kernel's epilogue applies (float32, sm_90a).
#pragma once

#include <cuda_runtime.h>

namespace gnnk {

enum Activation : int { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu: {  // tanh approximation, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

}  // namespace gnnk
