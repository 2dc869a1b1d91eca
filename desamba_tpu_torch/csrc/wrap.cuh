// int32 arithmetic that wraps, as torch's and XLA's int32 arithmetic does.
// Signed overflow is undefined in C++, so these compute through uint32.
#pragma once

namespace dsb {

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

// |a|, with |INT_MIN| == INT_MIN (torch.abs and jnp.abs on int32)
__device__ __forceinline__ int abs_wrap(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

}  // namespace dsb
