// Host optimizer steps over fp32 state in host memory: Adam/AdamW, Adagrad
// and Lion (the port's copy of the repository's csrc/adam/dst_cpu_adam.cpp).
//
// Host code, not a device kernel: when the optimizer state is offloaded
// (``offload_optimizer.host_update``, ZeRO-Infinity) the update runs on the
// host cores instead of the card.  The loops are written so that the
// compiler's auto-vectorizer emits the widest SIMD the host has (-O3
// -march=native), with OpenMP across the cores.
//
// C ABI for ctypes.  bc1/bc2 are the bias corrections (1 - beta^t), taken by
// the caller.  Every state buffer is contiguous fp32 and updated in place;
// Adam's gradient may also be bf16 (a gradient that crossed the wire in
// bf16), widened inside the update's sweep.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float widen(float g) { return g; }

inline float widen(uint16_t g) {  // bf16: the high half of an fp32
  uint32_t bits = static_cast<uint32_t>(g) << 16;
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

template <typename G>
void adam_sweep(float* p, const G* g, float* m, float* v, int64_t n, float lr,
                float beta1, float beta2, float eps, float weight_decay,
                float bc1, float bc2, int adamw) {
  const float om_b1 = 1.0f - beta1;
  const float om_b2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = widen(g[i]);
    if (!adamw && weight_decay > 0.0f) grad += weight_decay * p[i];
    float mi = beta1 * m[i] + om_b1 * grad;
    float vi = beta2 * v[i] + om_b2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float update = (mi * inv_bc1) / (sqrtf(vi * inv_bc2) + eps);
    if (adamw && weight_decay > 0.0f) update += weight_decay * p[i];
    p[i] -= lr * update;
  }
}

}  // namespace

extern "C" {

// p -= lr * m_hat / (sqrt(v_hat) + eps), weight decay added to the gradient
// (Adam, adamw = 0) or to the update (AdamW, adamw = 1); ``g`` is fp32, or
// bf16 when ``g_bf16``.
void dst_cpu_adam_step(float* p, const void* g, int g_bf16, float* m, float* v,
                       int64_t n, float lr, float beta1, float beta2,
                       float eps, float weight_decay, float bc1, float bc2,
                       int adamw) {
  if (g_bf16)
    adam_sweep(p, static_cast<const uint16_t*>(g), m, v, n, lr, beta1, beta2,
               eps, weight_decay, bc1, bc2, adamw);
  else
    adam_sweep(p, static_cast<const float*>(g), m, v, n, lr, beta1, beta2,
               eps, weight_decay, bc1, bc2, adamw);
}

// Adagrad: h += g^2; p -= lr * g / (sqrt(h) + eps), L2 decay on the gradient.
void dst_cpu_adagrad_step(float* p, const float* g, float* h, int64_t n,
                          float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (weight_decay > 0.0f) grad += weight_decay * p[i];
    float hi = h[i] + grad * grad;
    h[i] = hi;
    p[i] -= lr * grad / (sqrtf(hi) + eps);
  }
}

// Lion: p -= lr * (sign(beta1 m + (1 - beta1) g) + wd p), sign(0) = 0;
// m = beta2 m + (1 - beta2) g.
void dst_cpu_lion_step(float* p, const float* g, float* m, int64_t n,
                       float lr, float beta1, float beta2,
                       float weight_decay) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    float c = beta1 * m[i] + (1.0f - beta1) * grad;
    float update = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
    if (weight_decay > 0.0f) update += weight_decay * p[i];
    p[i] -= lr * update;
    m[i] = beta2 * m[i] + (1.0f - beta2) * grad;
  }
}

}  // extern "C"
