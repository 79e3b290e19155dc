"""`net.device_share.selfplay`, in the nested-bottleneck self-play cell."""

from harness.core import metric_reader

read = metric_reader("net.device_share.selfplay")
