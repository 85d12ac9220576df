"""Lock ranks and the runtime lock-order witness (copies of ``repro.analysis``)."""
