"""`selfplay_rollouts_per_s` of the host-bound self-play cell, a metric of
its own so that its bound does not widen the net-bound cell's."""

from harness.core import metric_reader

read = metric_reader("selfplay_rollouts_per_s")
