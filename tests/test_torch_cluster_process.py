"""PyTorch port, the fleet in process mode: ``tests/test_cluster.py::
test_process_mode_workers_map_one_segment`` against the port alone, on
``device="cpu"`` with 2 spawned workers.

The frontend exports its held slot as one shared-memory segment, and each
spawned worker copies it onto the frontend's device.  Reads routed through
the SLB equal the frontend's own store.  A write is shipped through the
durable replication log and replayed on every replica before its ack
(read-your-write on each worker).  Killing the owner of a paged select
hands the remaining pages to a survivor, and the released pin unblocks
``gc_ts`` there.  The fleet then commits after the failover.  Every wait
has a deadline and the fleet is closed in ``finally``
(``torch_fleet_script.case_process_mode_workers_map_one_segment``).
"""
import torch_fleet_script as script
from test_torch_cluster import port_namespace
from test_torch_store_index_edges import one_torch_thread  # noqa: F401


def test_process_mode_workers_map_one_segment():
    rec = script.run(port_namespace(),
                     "process_mode_workers_map_one_segment")
    step = rec.steps[0]
    assert step["attached"] == [0, 1]          # both workers attached
    assert step["stats"]["replicated_waves"] >= 3
    assert step["stats"]["worker_kills"] == 1
    assert step["stats"]["takeovers"] == 1
