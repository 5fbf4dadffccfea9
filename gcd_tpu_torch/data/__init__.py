"""The host data pipeline of the Kubric-4D training path (port of gcd_tpu/data):
frame preprocessing and trajectories (`common`), camera math and the point
splat (`geometry`, `gcd_tpu_torch.native`), the dataset (`kubric`), the
threaded loader and the device transfer (`loader`), and synthetic roots
(`fake`)."""
