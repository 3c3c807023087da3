// Standalone C++ serving demo of the PyTorch port — the api/demo_ci
// capability (port of paddle_tpu/serving/demo.cc: a plain C++ program
// consuming the predictor library with no Python in its source).
//
//   ./ptpu_demo <model_dir> <repo_or_sys_path> [device]
//
// device: "cuda", "cpu", ...; absent or "" means the card. Loads the
// exported model, builds a deterministic input for each declared signature
// entry (float ramp 0,1,2,.../100; integer ramp k % 7; bfloat16 ramp as
// its bits), runs it twice, prints every output as
// "output <i> shape=... dtype=... sum=..." — the tests compare the sum
// against the Python predictor on the same input.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
typedef struct {
  int dtype;
  int rank;
  const int64_t* shape;
  const void* data;
} PtpuTensor;

void* ptpu_create(const char*, const char*, const char*);
int ptpu_ok(void*);
const char* ptpu_last_error(void*);
int ptpu_num_inputs(void*);
int ptpu_input_rank(void*, int);
const int64_t* ptpu_input_shape(void*, int);
int ptpu_input_dtype(void*, int);
int ptpu_run(void*, const PtpuTensor*, int);
int ptpu_num_outputs(void*);
int ptpu_output_rank(void*, int);
const int64_t* ptpu_output_shape(void*, int);
int ptpu_output_dtype(void*, int);
const void* ptpu_output_data(void*, int);
int64_t ptpu_output_nbytes(void*, int);
void ptpu_destroy(void*);
}

namespace {

// float -> bfloat16 bits, round to nearest even (the ramp is finite)
uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  return (uint16_t)(u >> 16);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <model_dir> <sys_path> [device]\n", argv[0]);
    return 2;
  }
  void* h = ptpu_create(argv[1], argv[2], argc > 3 ? argv[3] : nullptr);
  if (!ptpu_ok(h)) {
    fprintf(stderr, "create failed: %s\n", ptpu_last_error(h));
    ptpu_destroy(h);
    return 1;
  }

  int n_in = ptpu_num_inputs(h);
  std::vector<PtpuTensor> tensors(n_in);
  std::vector<std::vector<float>> f32_bufs(n_in);
  std::vector<std::vector<int32_t>> i32_bufs(n_in);
  std::vector<std::vector<uint16_t>> bf16_bufs(n_in);
  for (int i = 0; i < n_in; i++) {
    int rank = ptpu_input_rank(h, i);
    const int64_t* shape = ptpu_input_shape(h, i);
    int dtype = ptpu_input_dtype(h, i);
    int64_t elems = 1;
    for (int d = 0; d < rank; d++) elems *= shape[d];
    if (dtype == 0) {  // float32 ramp
      f32_bufs[i].resize(elems);
      for (int64_t k = 0; k < elems; k++)
        f32_bufs[i][k] = (float)(k % 100) / 100.0f;
      tensors[i] = {0, rank, shape, f32_bufs[i].data()};
    } else if (dtype == 2 || dtype == 3) {  // int ramp (served as i32)
      i32_bufs[i].resize(elems);
      for (int64_t k = 0; k < elems; k++) i32_bufs[i][k] = (int32_t)(k % 7);
      tensors[i] = {2, rank, shape, i32_bufs[i].data()};
    } else if (dtype == 7) {  // bfloat16 ramp
      bf16_bufs[i].resize(elems);
      for (int64_t k = 0; k < elems; k++)
        bf16_bufs[i][k] = to_bf16((float)(k % 100) / 100.0f);
      tensors[i] = {7, rank, shape, bf16_bufs[i].data()};
    } else {
      fprintf(stderr, "demo: unsupported input dtype %d\n", dtype);
      ptpu_destroy(h);
      return 1;
    }
  }

  if (ptpu_run(h, tensors.data(), n_in) != 0) {
    fprintf(stderr, "run failed: %s\n", ptpu_last_error(h));
    ptpu_destroy(h);
    return 1;
  }

  // run twice to prove the loaded program is reusable (ZeroCopyRun cadence)
  if (ptpu_run(h, tensors.data(), n_in) != 0) {
    fprintf(stderr, "second run failed: %s\n", ptpu_last_error(h));
    ptpu_destroy(h);
    return 1;
  }

  int n_out = ptpu_num_outputs(h);
  for (int i = 0; i < n_out; i++) {
    int rank = ptpu_output_rank(h, i);
    const int64_t* shape = ptpu_output_shape(h, i);
    int dtype = ptpu_output_dtype(h, i);
    printf("output %d shape=", i);
    for (int d = 0; d < rank; d++)
      printf("%lld%s", (long long)shape[d], d + 1 < rank ? "x" : "");
    double sum = 0.0;
    if (dtype == 0) {
      const float* p = (const float*)ptpu_output_data(h, i);
      int64_t n = ptpu_output_nbytes(h, i) / 4;
      for (int64_t k = 0; k < n; k++) sum += p[k];
    }
    printf(" dtype=%d sum=%.6f\n", dtype, sum);
  }
  ptpu_destroy(h);
  return 0;
}
