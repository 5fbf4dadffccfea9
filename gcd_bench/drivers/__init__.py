"""One driver per kind of traffic, named by the traffic file's "driver":
`run(run)` builds the program under test, warms it up, measures the window,
takes the traced run's profiler slices, frees the program, and checks its
outputs against the reference."""
