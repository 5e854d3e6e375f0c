"""Jobs answered in the window per second of the window (host clock), in a
cell whose every job builds and compiles its own circuit. Host planning
takes most of such a job, and the host's speed varies too much from run
to run for a bound, so the rate is read per layer there."""

from portbench.metrics.jobs_per_s import read  # noqa: F401
