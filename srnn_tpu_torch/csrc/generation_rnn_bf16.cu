// K3, recurrent body over a bfloat16 population (population_dtype='bf16'):
// generation_rnn.cu's body and entry point instantiated for __nv_bfloat16
// population operands, as srnn_rnn_generation_bf16.  Loads upcast to float,
// every phase computes in float, the store rounds once to nearest even
// (generation_common.cuh); fresh, loss and dead masks stay float32 / int32.
//
// Replaces the bfloat16 path of the Pallas TPU kernel
// srnn_tpu/ops/pallas_generation.py, generation_popmajor (its loads'
// .astype(f32) and the store's .astype(out_ref.dtype)).
//
// What bounds it on an H100: as generation_rnn.cu, with the population's
// bytes halved (2 per element; the fresh columns stay 4).  A source of its
// own, so that the longest nvcc of the parallel build does not grow.

#define SRNN_GEN_BF16
#include "generation_rnn.cu"
