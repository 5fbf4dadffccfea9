"""The host data pipelines of the training entry (port of gcd_tpu/data):
frame preprocessing, trajectories and ParallelDomain frame loading
(`common`), camera math and the point splat (`geometry`,
`gcd_tpu_torch.native`), the PNG reader and writer (`png`), the Kubric-4D
and ParallelDomain-4D datasets (`kubric`, `pardom`), the threaded loader and
the device transfer (`loader`), and synthetic roots (`fake`)."""
