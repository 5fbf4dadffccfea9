"""The sgm sampling family of gcd_tpu/diffusion/: ladders, scalings,
denoisers, guiders and samplers, the per-step noise of the churned and
ancestral samplers passed in; and the training loss's parts."""

from gcd_tpu_torch.diffusion.denoiser import Denoiser, DiscreteDenoiser
from gcd_tpu_torch.diffusion.discretization import EDMDiscretization, LegacyDDPMDiscretization
from gcd_tpu_torch.diffusion.guiders import IdentityGuider, LinearPredictionGuider, VanillaCFG
from gcd_tpu_torch.diffusion.sampling import (
    DPMPP2MSampler,
    DPMPP2SAncestralSampler,
    EDMSampler,
    EulerAncestralSampler,
    EulerEDMSampler,
    HeunEDMSampler,
    LinearMultistepSampler,
)
from gcd_tpu_torch.diffusion.scaling import (
    DumbScaling,
    EDMScaling,
    EpsScaling,
    VScaling,
    VScalingWithEDMcNoise,
)
