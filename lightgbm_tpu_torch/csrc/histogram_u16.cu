// The histogram kernel of histogram.cu over uint16 bins (max_bin > 255,
// and EFB bundle columns of more than 256 bins): the same source built
// as a library of its own, so that nvcc compiles both bin types in
// parallel. Entries lgbm_histogram_u16_{f32,f64,i8,i16}[_dev].
#define LGBM_BIN_T uint16_t
#define LGBM_ENTRY(name) lgbm_histogram_u16_##name
#include "histogram.cu"
