"""The paper's own models and the codecs, copied from the JAX package so
the port imports nothing of it: the layer tables and the cycle and
memory-access models (``core.model``), the bit-faithful Slice/Core/Engine
emulator (``core.engine``), the slice simulator (``core.slice_sim``), the
design-space exploration (``core.explore``), the int8/int5 codecs
(``core.quant``) and the tree helpers (``core.tree``)."""
