"""Dense transformer layers, the Mamba-2 mixer and the model assembler (ports of ``repro.models``)."""
