"""ray_tpu_torch.data: streaming datasets feeding training on the card.

Port of `ray_tpu/data/`, each module a complete copy (the package
imports no JAX), with `torch_iter.iter_torch_batches` in place of
`jax_iter.iter_jax_batches`: read → map_batches → shuffle →
iter_batches, executed as bounded-window remote tasks over the port's
runtime, then batches copied onto the card ahead of the step.

The names below resolve at first use, where the JAX package imports
every submodule here. A worker that unpickles a read task on its
connection thread while its task thread unpickles a stage function
imports two submodules at once; with an eager package, each thread held
one submodule's import lock and waited for the package the other was
running, and one of them got a half-imported module ("cannot import
name ... from partially initialized module", or a KeyError that lost
the message being decoded, so a `get` waited forever; ROADMAP queue 3,
item 10). The submodules import no cycle among themselves.
"""
import importlib

_EXPORTS = {
    "AbsMax": "aggregate", "AggregateFn": "aggregate", "Count": "aggregate",
    "Max": "aggregate", "Mean": "aggregate", "Min": "aggregate",
    "Std": "aggregate", "Sum": "aggregate",
    "Block": "block", "BlockMetadata": "block",
    "ActorPoolStrategy": "dataset", "DataIterator": "dataset",
    "Dataset": "dataset", "from_items": "dataset", "from_numpy": "dataset",
    "range": "dataset", "read_csv": "dataset",
    "read_binary_files": "dataset", "read_images": "dataset",
    "read_json": "dataset", "read_parquet": "dataset",
    "read_text": "dataset", "read_tfrecords": "dataset",
    "GroupedData": "grouped_data",
    "StageSpec": "streaming",
    "iter_torch_batches": "torch_iter",
}


def __getattr__(name: str):
    if name == "aggregate":
        return importlib.import_module(f"{__name__}.aggregate")
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = [
    "Block", "BlockMetadata", "DataIterator", "Dataset", "from_items",
    "from_numpy", "range", "read_csv", "read_json", "read_parquet",
    "read_text", "read_binary_files", "read_images", "read_tfrecords",
    "iter_torch_batches", "ActorPoolStrategy", "GroupedData", "StageSpec",
    "AggregateFn", "Count", "Sum", "Min", "Max", "Mean", "Std", "AbsMax",
    "aggregate",
]
