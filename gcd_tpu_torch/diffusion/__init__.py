"""EDM sampling path: the parts of gcd_tpu/diffusion/ that GCD's inference
configs use."""

from gcd_tpu_torch.diffusion.denoiser import Denoiser
from gcd_tpu_torch.diffusion.discretization import EDMDiscretization
from gcd_tpu_torch.diffusion.guiders import LinearPredictionGuider
from gcd_tpu_torch.diffusion.sampling import EulerEDMSampler
from gcd_tpu_torch.diffusion.scaling import VScalingWithEDMcNoise
