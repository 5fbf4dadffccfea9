"""The port's VideoUNet at each residual-block and blend option of the JAX
package's VideoUNet alone, on TINY_UNET, against the JAX network (weights
carried by the weight bridge, strict=True). The transformer options are in
tests/test_torch_unet_attention_options.py, the combined configs and the
JAX package's defaults in tests/test_torch_unet_configs.py.

fp32 on the CPU (the wrappers take their plain versions there), JAX at
highest matmul precision: the 1e-4 bound of the other UNet tests catches any
wrong key, layout, resample, norm or routing.
"""

import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_unet_helpers import check_option


@pytest.mark.parametrize("option,value", [
    ("use_scale_shift_norm", True), ("resblock_updown", True), ("conv_resample", False),
    ("merge_strategy", "fixed"), ("video_kernel_size", 3),
])
def test_option_matches_jax(option, value):
    port = check_option({option: value}, 3)
    if option == "merge_strategy":
        assert not any(k.endswith("mix_factor") for k in port.state_dict())
