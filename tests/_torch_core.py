"""The fixtures of ``tests/conftest.py`` rooted at ``repro_torch``.

The conftest's ``warehouse``, ``session`` and ``star_schema`` build on the
JAX package. The ``test_torch_core_*`` copies of its ``core`` tests import
these instead (pytest collects fixtures from a test module's globals; this
module's name keeps it from being collected itself). The session takes the
reference's default engine, ``auto``, explicitly: the port defaults to
``cuda``, which needs a card.
"""
import numpy as np
import pytest


@pytest.fixture()
def warehouse(tmp_path):
    from repro_torch.core.session import Warehouse

    return Warehouse(str(tmp_path / "wh"))


@pytest.fixture()
def session(warehouse):
    return warehouse.session(engine="auto")


@pytest.fixture()
def star_schema(warehouse):
    """Small star schema used across optimizer/MV/benchmark-style tests."""
    from repro_torch.core.acid import AcidTable
    from repro_torch.core.runtime.vector import VectorBatch

    s = warehouse.session(engine="auto")
    hms = warehouse.hms
    s.execute("CREATE TABLE date_dim (d_date_sk INT, d_year INT, d_moy INT)")
    s.execute("CREATE TABLE item (i_item_sk INT, i_category STRING, i_price DOUBLE)")
    s.execute(
        "CREATE TABLE store_sales (ss_item_sk INT, ss_date_sk INT,"
        " ss_customer_sk INT, ss_qty INT, ss_price DOUBLE)"
    )
    rng = np.random.default_rng(7)
    nd, ni, n = 36, 60, 8000
    tx = hms.open_txn()
    AcidTable(hms.get_table("date_dim"), hms).insert(tx, VectorBatch({
        "d_date_sk": np.arange(nd),
        "d_year": 2016 + np.arange(nd) // 12,
        "d_moy": np.arange(nd) % 12 + 1,
    }))
    AcidTable(hms.get_table("item"), hms).insert(tx, VectorBatch({
        "i_item_sk": np.arange(ni),
        "i_category": np.array(["Sports", "Books", "Home", "Toys", "Music"])[
            np.arange(ni) % 5],
        "i_price": rng.uniform(1, 100, ni).round(2),
    }))
    AcidTable(hms.get_table("store_sales"), hms).insert(tx, VectorBatch({
        "ss_item_sk": rng.integers(0, ni, n),
        "ss_date_sk": rng.integers(0, nd, n),
        "ss_customer_sk": rng.integers(0, 300, n),
        "ss_qty": rng.integers(1, 10, n),
        "ss_price": rng.uniform(1, 100, n).round(2),
    }))
    hms.commit_txn(tx)
    return warehouse
