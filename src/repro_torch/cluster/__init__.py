"""Disaggregated prefill/decode serving cluster (port of
``repro/cluster``).

Layers: transport (bus.py) < worker (worker.py) < control plane
(router.py + placement.py + control.py), with handoff.py carrying KV
pages across the prefill-to-decode boundary.
"""
from repro_torch.cluster.bus import (LocalBus, ProcBus, WorkerFailed,
                                     WorkerKilled)
from repro_torch.cluster.control import ClusterMonitor, ControlConfig
from repro_torch.cluster.handoff import KVHandoff
from repro_torch.cluster.placement import (WorkerView, choose_decode,
                                           choose_prefill)
from repro_torch.cluster.router import ClusterConfig, GlobalPrefixMap, Router
from repro_torch.cluster.worker import ClusterWorker, WorkerSpec, build_engine
