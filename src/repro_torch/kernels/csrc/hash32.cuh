// Counter-based element randomness shared by the capscore kernels: the
// splitmix32-style avalanche of core/hashing.py, the salt lanes of
// core/samplers.py and the 24-bit uniform in (0, 1).  Every operation is
// one exact uint32 op or one IEEE f32 rounding, so a kernel that uses these
// reproduces the plain PyTorch version's hashes and uniforms bit for bit.
#pragma once

#include <stdint.h>

namespace hash32 {

constexpr uint32_t C1 = 0x7FEB352Du;
constexpr uint32_t C2 = 0x846CA68Bu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t SEED0 = 0x243F6A88u;
constexpr uint32_t SALT_ELEM = 0x01u;  // core/samplers.py
constexpr uint32_t SALT_KEYBASE = 0x03u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= C1;
  x ^= x >> 15;
  x *= C2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t p) {
  return mix32(h ^ (p + GOLDEN + (h << 6) + (h >> 2)));
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return combine(combine(combine(SEED0, a), b), c);
}

// top 24 bits -> f32 in (0, 1): exact, one add and one power-of-two product
__device__ __forceinline__ float u01(uint32_t h) {
  return (static_cast<float>(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

}  // namespace hash32
