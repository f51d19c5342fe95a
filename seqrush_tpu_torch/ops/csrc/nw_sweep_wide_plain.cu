// Kernel A's wide route, single-shot, with plain compares: the kernels for
// int32 penalties outside [0, 2^16) (nw_sweep_wide.cuh's kPlain), in a
// source of their own so that nvcc builds them beside nw_sweep_wide.cu's.

#include "nw_sweep_wide.cuh"

const void* nw_sweep_wide_plain_kernel(int lanes, bool two, bool tb, bool solo) {
  return wide_kernel_of<kPlain>(lanes, two, tb, solo);
}
