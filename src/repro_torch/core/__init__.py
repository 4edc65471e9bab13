"""The machine model: neurons, synapses, STP, correlation sensors, CADC,
the PPU vector unit and the §5 hybrid-plasticity experiment."""
