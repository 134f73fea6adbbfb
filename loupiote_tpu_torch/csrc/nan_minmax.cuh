// min / max of the slab tests of K1 (wide_traverse.cu), K2 / K3
// (bvh2_traverse.cu), E1 (kernel_probe.cu, its per-lane keys too), E2
// (lane_gather.cu), E6 / E7 (treelet_traverse.cu) and of E3's segmin
// (r3_probes.cu): PTX min.NaN / max.NaN return
// NaN where either operand is NaN, as the twins' torch.minimum / maximum
// and the reference's jnp.minimum / maximum do (fminf / fmaxf return the
// other operand, so a ray with a NaN slab term, from a NaN origin or an
// infinite origin along an infinite direction, would test boxes the twin
// skips). Each is one FMNMX, as fminf / fmaxf.
#pragma once

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
