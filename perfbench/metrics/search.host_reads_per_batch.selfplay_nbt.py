"""`search.host_reads_per_batch.selfplay`, in the nested-bottleneck self-play cell."""

from harness.core import metric_reader

read = metric_reader("search.host_reads_per_batch.selfplay")
