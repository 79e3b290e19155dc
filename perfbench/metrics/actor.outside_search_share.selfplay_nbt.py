"""`actor.outside_search_share.selfplay`, in the nested-bottleneck self-play cell."""

from harness.core import metric_reader

read = metric_reader("actor.outside_search_share.selfplay")
