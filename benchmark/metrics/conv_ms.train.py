"""Model layer: device ms a step in convolution kernels (cuDNN's and the
FFT transforms it runs them by), over the traced round's steps. cuDNN's
batch-norm kernels carry "cudnn" in their names, so they are left out."""

from benchmark.harness.readers import kernel_ms_per_step

UNIT = "ms"
INCLUDE = ("conv", "xmma", "implicit", "gemm", "cudnn", "sm90", "cutlass", "winograd", "fft",
           "region_transform")
EXCLUDE = ("batch_norm", "bn_", "batchnorm", "welford")


def read(record):
    return kernel_ms_per_step(record, INCLUDE, EXCLUDE)
