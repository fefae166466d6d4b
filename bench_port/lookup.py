"""Where the harness finds each piece of a cell by the name that
``BENCHMARK.json``, a configuration or a traffic file gives it:

  configs/<config>.json   a configuration: sizes, source, guarantee, the
                          checks' limits, and ``small``, its size in the
                          CPU self-check
  traffic/<traffic>.json  a traffic mix: the entry, the pool, warm-up,
                          sample and spans
  metrics/<metric>.py     a metric's ``read(run)``: the number, or None if
                          there is nothing to read
  kinds/<kind>.py         a data generator's ``make(cfg, g, device)``, for a
                          kind that is not in ``gen.KINDS``
  calls/<entry>.py        a request kind's ``ENTRY`` (a subclass of
                          ``entries.Entry``) and ``control(data, cell,
                          device)``, for an entry that is not in
                          ``entries.ENTRIES``

A later cell adds files here; none of this code changes for it.
"""
from __future__ import annotations

import hashlib
import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS_DIR = HERE / "configs"
TRAFFIC_DIR = HERE / "traffic"
METRICS_DIR = HERE / "metrics"
KINDS_DIR = HERE / "kinds"
CALLS_DIR = HERE / "calls"


def load(directory: Path, name: str):
    """The module of ``<directory>/<name>.py``, run once per process.

    It is entered in ``sys.modules`` before it runs, under a name made
    from its path: a ``@dataclass`` under ``from __future__ import
    annotations`` looks its module up there, and two files of one name in
    two directories stay two modules."""
    path = (Path(directory) / f"{name}.py").resolve()
    digest = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    module_name = re.sub(r"\W", "_", f"bench_port_{path.parent.name}_{name}",
                         flags=re.ASCII) + "_" + digest
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def find(table: dict, table_name: str, directory: Path, name: str,
         export: str):
    """``table[name]``, else the ``export`` of ``<directory>/<name>.py``.

    A name in neither place is refused with one message that names both."""
    if name in table:
        return table[name]
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"{name!r} is neither in {table_name} "
                          f"({', '.join(sorted(table))}) nor a file {path}")
    value = getattr(load(directory, name), export, None)
    if value is None:
        raise LookupError(f"{path} defines no {export}")
    return value
