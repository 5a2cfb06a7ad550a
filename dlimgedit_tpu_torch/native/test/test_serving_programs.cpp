// Per-program check of a serving bundle: each program runs through the
// port's serving library on the sample inputs the exporter saved, and its
// outputs are compared byte for byte with the port's Python path's
// (<name>.out<i>.npy). Separates the C++ runner (arguments, weights,
// dtypes) from the pipeline around it (test_serving.cpp). The port's copy
// of the JAX package's native/test/test_serving_programs.cpp.
//
// The process is a host that shares libtorch: it sets ATen's float32
// flags away from full precision first, and they must hold its values
// again after the programs ran (at full precision). Prints the weights
// the backend holds on its device, each once for every program, and how
// many of the programs passed, out of those given and of the bundle's
// (its spec files).
//
//   test_serving_programs [cpu|gpu] <bundle_dir> <program>...

#include <ATen/Context.h>

#include <cstdio>
#include <cstring>
#include <filesystem>
#include <string>

#include "../src/torch_backend.hpp"

int main(int argc, char** argv) {
  std::setbuf(stdout, nullptr);
  int argi = 1;
  int device = dlimg_torch::kCpu;
  if (argi < argc && (std::strcmp(argv[argi], "cpu") == 0 ||
                      std::strcmp(argv[argi], "gpu") == 0))
    device = std::strcmp(argv[argi++], "gpu") == 0 ? dlimg_torch::kCuda
                                                   : dlimg_torch::kCpu;
  if (argc - argi < 2) {
    std::fprintf(stderr, "usage: %s [cpu|gpu] <bundle_dir> <program>...\n",
                 argv[0]);
    return 2;
  }
  at::Context& ctx = at::globalContext();
  ctx.setFloat32MatmulPrecision("high");
  ctx.setAllowTF32CuDNN(true);
  std::string err;
  const std::string bundle = argv[argi++];
  dlimg_torch::Backend* be = dlimg_torch::create(bundle, device, &err);
  if (!be) {
    std::fprintf(stderr, "FATAL: backend: %s\n", err.c_str());
    return 1;
  }
  int failures = 0;
  for (int i = argi; i < argc; ++i) {
    std::string report;
    bool ok = dlimg_torch::validate(be, argv[i], &report, &err);
    std::printf("%s%s: %s\n", report.c_str(), argv[i],
                ok ? "PASS" : ("FAIL (" + err + ")").c_str());
    failures += !ok;
  }
  int in_bundle = 0;
  for (const auto& e : std::filesystem::directory_iterator(bundle)) {
    const std::string f = e.path().filename().string();
    in_bundle += f.size() > 9 && f.compare(f.size() - 9, 9, ".spec.txt") == 0;
  }
  std::printf("programs byte-equal to the exporter's outputs: %d of %d "
              "given, the bundle has %d\n", argc - argi - failures,
              argc - argi, in_bundle);
  int64_t count = 0, bytes = 0;
  dlimg_torch::held_weights(be, &count, &bytes);
  std::printf("weights held on the device: %lld tensors, %lld bytes\n",
              (long long)count, (long long)bytes);
  dlimg_torch::destroy(be);
  bool kept = ctx.float32MatmulPrecision() == at::Float32MatmulPrecision::HIGH &&
              ctx.allowTF32CuBLAS() && ctx.allowTF32CuDNN();
  std::printf("the host's float32 flags after the programs: %s\n",
              kept ? "put back" : "CHANGED");
  failures += !kept;
  return failures == 0 ? 0 : 1;
}
