"""Dense transformer layers and the model assembler (ports of ``repro.models``)."""
