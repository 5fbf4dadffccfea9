from gcd_tpu_torch.ops.dispatch import current_flags, kernel_enabled, kernel_flags
from gcd_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from gcd_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
from gcd_tpu_torch.ops.fused_mlp import geglu_mlp, geglu_mlp_plain
from gcd_tpu_torch.ops.fused_norm import (
    group_norm,
    group_norm_plain,
    group_stats,
    group_stats_plain,
)
from gcd_tpu_torch.ops.temporal_attention import (
    temporal_attention,
    temporal_attention_plain,
)

# The port's kernel wrappers, each with a plain-integer `launches` count.
KERNELS = {"flash": flash_attention, "flash_bwd": flash_attention_bwd,
           "tattn": temporal_attention,
           "fused_mlp": geglu_mlp, "fused_gn": group_norm, "gn_stats": group_stats,
           "fused_gn_conv": gn_silu_conv3x3}
