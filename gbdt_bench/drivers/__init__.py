"""One module per traffic mix's ``driver``: ``run(r)`` sets up a cell from
``r`` (:class:`gbdt_bench.harness.Run`), measures its window and hands
back a :class:`gbdt_bench.harness.Outcome`."""
import importlib


def driver_for(name: str):
    return importlib.import_module(__name__ + "." + name).run
