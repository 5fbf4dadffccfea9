"""Device ms of the kernels inside one UNet evaluation (the bench.unet range), mean."""

from gcd_bench import readers


def read(run):
    return readers.device_ms(run, "bench.unet")
