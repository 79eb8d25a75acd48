"""`device_idle_share` in the cells whose end-to-end rate is `proofs_per_s.device`:
the same reader, under the name that moves that metric."""

from perfbench.harness.registry import metric_reader

read = metric_reader("device_idle_share").read
