// The MLP activations of the fused-MLP kernels (fused_mlp.cu, the forward;
// fused_mlp_bwd.cu, the backward) and their derivatives, in f32.
// act: 0 silu, 1 gelu (tanh form, as jax.nn.gelu), 2 relu, 3 squared relu.

#pragma once

namespace mlp_act {

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case 0: return v / (1.f + expf(-v));
    case 1: {
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case 2: return fmaxf(v, 0.f);
    default: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
  }
}

// d activate(act, v) / dv; relu's is 0 at 0, as jax.nn.relu's
__device__ __forceinline__ float activate_grad(int act, float v) {
  switch (act) {
    case 0: {
      const float s = 1.f / (1.f + expf(-v));
      return s * (1.f + v * (1.f - s));
    }
    case 1: {
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (v + 0.044715f * v * v * v));
      return 0.5f * (1.f + t) +
             0.5f * v * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * v * v);
    }
    case 2: return v > 0.f ? 1.f : 0.f;
    default: return v > 0.f ? 2.f * v : 0.f;
  }
}

// the logistic sigmoid
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// activate(act, v) and activate_grad(act, v) at once, the sigmoid (silu)
// or the tanh (gelu) computed once for both: gelu, relu and squared relu
// give activate's and activate_grad's bits, silu's v σ(v) is within an ulp
// of activate's v / (1 + e^-v)
__device__ __forceinline__ void activate_and_grad(int act, float v, float& a,
                                                  float& da) {
  switch (act) {
    case 0: {
      const float s = sigmoid(v);
      a = v * s;
      da = s * (1.f + v * (1.f - s));
      return;
    }
    case 1: {
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (v + 0.044715f * v * v * v));
      a = 0.5f * v * (1.f + t);
      da = 0.5f * (1.f + t) +
           0.5f * v * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * v * v);
      return;
    }
    case 2:
      a = fmaxf(v, 0.f);
      da = v > 0.f ? 1.f : 0.f;
      return;
    default: {
      const float r = fmaxf(v, 0.f);
      a = r * r;
      da = v > 0.f ? 2.f * v : 0.f;
    }
  }
}

}  // namespace mlp_act
