// The flash kernel's launches with query positions (q_pos): flash.cu's
// QPOS instantiations, in a translation unit of their own so that nvcc
// compiles them beside flash.cu's others (kernels/_build.py starts one
// nvcc a source). The kernels and their contract are flash.cu's.
#define FLASH_QPOS_UNIT
#include "flash.cu"
