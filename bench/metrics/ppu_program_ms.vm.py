"""Device time of one trial's PPU program (all instances of the fleet
together: the reward, both CADC reads, the program's Q8.8 operands, the
``ppuvm_exec`` launch over every synapse, the weight store's conversion
and the sensors' reset), in ms: the mean of the program's
``trial.ppu_program`` region, timed by event-record nodes inside the
captured trial graph on the last trial of every call. A program that
does not split this region off reads nothing."""
from harness.spans import span_mean_ms


def read(run):
    return span_mean_ms(run, "trial.ppu_program")
