"""repro_torch.launch — launchers of the port (port of ``repro.launch``):
:mod:`.serve`, batched decode serving."""
