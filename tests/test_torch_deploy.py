"""The port's cluster roles as OS processes (ROADMAP A10-proc): every
test of tests/test_deploy.py runs once more against `python -m
greptimedb_tpu_torch metasrv|datanode|frontend|flownode start ...
--device cpu` (tests/torch_twin.py): SQL through a frontend over remote
metadata and remote regions, kill -9 failover driven by the metasrv's
own ticker, a flownode ticking a flow, a region migration over the wire
and a datanode closing its region when its lease lapses."""

from torch_twin import twin

globals().update(twin("test_deploy.py", [
    "cluster", "test_cli_cluster_sql_and_failover",
    "test_flownode_process_ticks_flows",
    "test_region_migration_over_the_wire",
    "test_datanode_self_close_on_lease_expiry"], subs=(
    # the roles of the port, on the CPU
    (r'"-m", "greptimedb_tpu", \*args\]',
     '"-m", "greptimedb_tpu_torch", *args, "--device", "cpu"]'),)))
