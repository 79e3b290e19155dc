"""`search.backprop_share.selfplay`, in the host-bound self-play cell (it moves
`selfplay_rollouts_per_s.host_bound`)."""

from harness.core import metric_reader

read = metric_reader("search.backprop_share.selfplay")
