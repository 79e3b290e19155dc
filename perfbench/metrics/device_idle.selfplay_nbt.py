"""`device_idle.selfplay`, in the nested-bottleneck self-play cell."""

from harness.core import metric_reader

read = metric_reader("device_idle.selfplay")
