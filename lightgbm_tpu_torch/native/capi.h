/*
 * C API for the lightgbm_tpu inference runtime (_capi.so).
 *
 * Predict-side surface of the reference's C API
 * (reference: include/LightGBM/c_api.h): load a v3 model text file —
 * produced by this framework or by the original implementation, the
 * formats interchange bit-exactly — and run dense/CSR prediction from
 * any C host with no Python runtime. Training entry points are Python
 * by design (docs/PARITY.md, layer 8).
 *
 * All functions return 0 on success, nonzero on failure;
 * LGBM_GetLastError() describes the most recent failure on this thread.
 */
#ifndef LIGHTGBM_TPU_CAPI_H_
#define LIGHTGBM_TPU_CAPI_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* BoosterHandle;

/* data_type values for prediction inputs */
#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32   (2)
#define C_API_DTYPE_INT64   (3)

/* predict_type values */
#define C_API_PREDICT_NORMAL     (0)  /* transformed score */
#define C_API_PREDICT_RAW_SCORE  (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB    (3)  /* SHAP values, last col = bias */

const char* LGBM_GetLastError(void);

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterFree(BoosterHandle handle);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                    int* out_iteration);
int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int start_iteration,
                               int num_iteration, int64_t* out_len);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterPredictForMatSingleRow(BoosterHandle handle,
                                       const void* data, int data_type,
                                       int32_t ncol, int is_row_major,
                                       int predict_type,
                                       int start_iteration,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len,
                                       double* out_result);
int LGBM_BoosterPredictForCSRSingleRow(BoosterHandle handle,
                                       const void* indptr,
                                       int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int predict_type,
                                       int start_iteration,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len,
                                       double* out_result);
int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename);
int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                  int start_iteration, int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str);
int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result);
int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len);
int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val);
int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val);
int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               const char* result_filename);
int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str);
int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int len,
                                int* out_len, size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs);

#ifdef __cplusplus
}
#endif

#endif  /* LIGHTGBM_TPU_CAPI_H_ */
