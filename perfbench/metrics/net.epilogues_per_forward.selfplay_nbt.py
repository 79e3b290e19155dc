"""`net.epilogues_per_forward.selfplay`, in the nested-bottleneck self-play
cell: every epilogue launch of any mode over the serving forwards, 118.0
for `b18c384nbt` (`yardstick_nbt.epilogues`)."""

from harness.core import metric_reader

read = metric_reader("net.epilogues_per_forward.selfplay")
