// Kernel A's wide route, single-shot, in the int16 mode: the kernels whose
// adds wrap to 16 bits, with signed keys (nw_sweep_wide.cuh's kKeyed16), in
// a source of their own so that nvcc builds them beside nw_sweep_wide.cu's.

#include "nw_sweep_wide.cuh"

const void* nw_sweep_wide_i16_kernel(int lanes, bool two, bool tb, bool solo) {
  return wide_kernel_of<kKeyed16>(lanes, two, tb, solo);
}
