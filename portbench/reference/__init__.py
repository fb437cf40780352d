"""The benchmark's plain reference: NumPy models of Sentinel's cluster
flow check (:mod:`.flow`) and hot-parameter check (:mod:`.param`), written
from the upstream semantics, each with the replay of the service's
batching and clock reads that a run recorded. Nothing here imports the
program or torch."""
