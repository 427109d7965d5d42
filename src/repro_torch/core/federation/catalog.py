"""First-class catalogs: mount a whole external system at once (paper §6).

``CREATE CATALOG sales USING jdbc WITH (db = '/data/crm.db')`` registers a
named connector instance; queries then address its tables with three-part
names (``sales.main.customers``, or two-part ``sales.customers`` through
the connector's default schema) without any per-table ``STORED BY`` DDL.

Remote schemas are discovered *lazily*: the first reference to
``catalog.schema.table`` asks the connector for the table's columns and the
resulting ``TableDesc`` is cached on the catalog (dropped by
``invalidate()``/``DROP CATALOG``).  Catalog definitions persist in the
metastore, so a re-opened warehouse re-mounts its catalogs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..metastore import Metastore, TableDesc

# connector name -> factory(props) -> StorageHandler instance
CONNECTORS: Dict[str, Callable[[dict], object]] = {}


def register_connector(name: str, factory: Callable[[dict], object]) -> None:
    CONNECTORS[name] = factory


def _builtin_connectors() -> None:
    if CONNECTORS:
        return
    from .druid import DruidHandler
    from .jdbc import JdbcHandler
    from .memtable import MemTableHandler

    register_connector("jdbc", JdbcHandler.from_props)
    register_connector("druid", DruidHandler.from_props)
    register_connector("memtable", MemTableHandler.from_props)


class Catalog:
    """One mounted external system: a connector instance + lazy schema cache."""

    def __init__(self, name: str, connector: str, props: Dict[str, str],
                 handler) -> None:
        self.name = name
        self.connector = connector
        self.props = dict(props)
        self.handler = handler
        self._descs: Dict[str, TableDesc] = {}

    @property
    def default_schema(self) -> str:
        return self.props.get("default_schema", self.handler.default_schema)

    def list_schemas(self) -> List[str]:
        return self.handler.list_schemas()

    def list_tables(self, schema: Optional[str] = None) -> List[str]:
        return self.handler.list_tables(schema or self.default_schema)

    def table_desc(self, schema: Optional[str], table: str) -> TableDesc:
        """Lazy remote-schema discovery, cached per (schema, table)."""
        schema = schema or self.default_schema
        key = f"{schema}.{table}"
        desc = self._descs.get(key)
        if desc is not None:
            return desc
        cols = self.handler.discover(schema, table)
        if cols is None:
            raise KeyError(
                f"catalog {self.name!r} has no table {schema}.{table}"
            )
        desc = TableDesc(
            name=f"{self.name}.{key}",
            schema=[tuple(c) for c in cols],
            partition_cols=[],
            location="",
            props={**self.props, **self.handler.table_props(schema, table)},
            handler=f"catalog:{self.name}",
        )
        self._descs[key] = desc
        return desc

    def invalidate(self) -> None:
        self._descs.clear()


class CatalogRegistry:
    """``Warehouse.catalogs``: name -> :class:`Catalog`, metastore-persisted."""

    def __init__(self, hms: Metastore):
        _builtin_connectors()
        self.hms = hms
        self._catalogs: Dict[str, Catalog] = {}
        for name, connector, props in hms.list_catalogs():
            self._catalogs[name] = self._instantiate(name, connector, props)

    @staticmethod
    def _instantiate(name: str, connector: str, props: Dict[str, str]) -> Catalog:
        factory = CONNECTORS.get(connector)
        if factory is None:
            raise ValueError(
                f"unknown connector {connector!r}; "
                f"available: {sorted(CONNECTORS)}"
            )
        return Catalog(name, connector, props, factory(props))

    def create(self, name: str, connector: str,
               props: Optional[Dict[str, str]] = None) -> Catalog:
        if name in self._catalogs:
            raise ValueError(f"catalog {name!r} already exists")
        cat = self._instantiate(name, connector, props or {})
        self.hms.create_catalog(name, connector, props or {})
        self._catalogs[name] = cat
        return cat

    def drop(self, name: str, if_exists: bool = False) -> None:
        if name not in self._catalogs:
            if if_exists:
                return
            raise KeyError(f"no catalog {name!r}")
        self.hms.drop_catalog(name)
        del self._catalogs[name]

    def get(self, name: str) -> Optional[Catalog]:
        return self._catalogs.get(name)

    def names(self) -> List[str]:
        return sorted(self._catalogs)

    def items(self):
        return self._catalogs.items()

    def handler_map(self) -> Dict[str, object]:
        """Execution-context handler entries for every mounted catalog."""
        return {f"catalog:{n}": c.handler for n, c in self._catalogs.items()}

    def __contains__(self, name: str) -> bool:
        return name in self._catalogs

    def __len__(self) -> int:
        return len(self._catalogs)
