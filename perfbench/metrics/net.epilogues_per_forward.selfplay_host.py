"""`net.epilogues_per_forward.selfplay`, in the host-bound self-play cell
(it moves `selfplay_rollouts_per_s.host_bound`): 21.0 for its 10-block
net."""

from harness.core import metric_reader

read = metric_reader("net.epilogues_per_forward.selfplay")
