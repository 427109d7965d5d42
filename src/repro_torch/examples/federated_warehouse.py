"""Federation: one SQL layer over Druid-style OLAP + a JDBC RDBMS (paper §6).

Registers external tables backed by both engines, shows Calcite-style
computation pushdown (Druid JSON / generated SQL), and a cross-engine join.

The port's copy of the JAX package's ``examples/federated_warehouse.py``;
the session takes ``--engine`` (default ``cuda``; ``ref`` or ``auto`` on the
CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.federated_warehouse
      [--engine auto]
"""
import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.runtime.vector import VectorBatch
from repro_torch.core.session import Warehouse


def main(engine: str = "cuda", warehouse_dir: Optional[str] = None):
    wh = Warehouse(warehouse_dir or tempfile.mkdtemp(prefix="tahoe_fed_"))
    s = wh.session(engine=engine)
    rng = np.random.default_rng(1)

    # -- a Druid datasource with event data (paper Figure 6)
    druid = wh.handlers.get("druid")
    druid.store.create_datasource("events", VectorBatch({
        "__time": np.array([f"2017-{1 + i % 12:02d}-01" for i in range(5000)]),
        "d1": np.array([f"user_{i % 9}" for i in range(5000)]),
        "m1": rng.uniform(0, 10, 5000),
    }))
    s.execute("""CREATE EXTERNAL TABLE druid_table_1
        STORED BY 'org.apache.hadoop.hive.druid.DruidStorageHandler'
        TBLPROPERTIES ('druid.datasource' = 'events')""")
    print("schema inferred from Druid:",
          wh.hms.get_table("druid_table_1").schema)

    r = s.execute("""SELECT d1, SUM(m1) AS st FROM druid_table_1
                     GROUP BY d1 ORDER BY st DESC LIMIT 5""")
    print("\npushed:", r.info.get("federated_pushdown"))
    print("druid JSON:", druid.store.queries_served[-1])
    for row in r.rows:
        print("  ", row)

    # -- a JDBC engine (embedded sqlite) with reference data
    jdbc = wh.handlers.get("jdbc")
    jdbc.load_table("users", VectorBatch({
        "uid": np.array([f"user_{i}" for i in range(9)]),
        "segment": np.array(["free", "pro", "enterprise"])[np.arange(9) % 3],
    }))
    s.execute("""CREATE EXTERNAL TABLE users STORED BY 'jdbc'
        TBLPROPERTIES ('jdbc.table'='users')""")
    r = s.execute("SELECT segment, COUNT(*) c FROM users GROUP BY segment")
    print("\nJDBC pushdown SQL:", jdbc.queries_served[-1])

    # -- cross-engine join, mediated by the warehouse (paper §6 'mediator')
    r = s.execute("""SELECT segment, SUM(m1) AS usage_sum
                     FROM druid_table_1, users
                     WHERE d1 = uid GROUP BY segment ORDER BY usage_sum DESC""")
    print("\ncross-engine join (Druid x sqlite):")
    for row in r.rows:
        print("  ", row)

    # -- write back to Druid (output format, §6.1)
    s.execute("CREATE EXTERNAL TABLE rollup_out (seg STRING, total DOUBLE)"
              " STORED BY 'druid'")
    s.execute("INSERT INTO rollup_out SELECT segment, SUM(m1) FROM"
              " druid_table_1, users WHERE d1 = uid GROUP BY segment")
    print("\nwrote rollup into Druid:",
          s.execute("SELECT COUNT(*) FROM rollup_out").rows)
    wh.close()


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="cuda",
                    help="cuda (default) | ref | auto")
    main(ap.parse_args(argv).engine)


if __name__ == "__main__":
    cli()
