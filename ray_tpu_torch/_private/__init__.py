"""The port's copy of the single-host runtime of `ray_tpu/_private/`:
the wire and protocol, the object store and object plane, the
controller, scheduler and workers, and the driver runtime. Each module
keeps its JAX counterpart's name and contents; process-wide names (the
session variable, shm segments, the spill directory, the native
library) are the port's own, so both runtimes can live in one
process."""
