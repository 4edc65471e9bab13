"""Device time of one trial's carry (all instances of the fleet
together: the histories written at the step counter, ``graph.assign``'s
state copies, the step advanced), in ms: the mean of the program's
``trial.carry`` region, timed by event-record nodes inside the captured
trial graph on the last trial of every call."""
from harness.spans import span_mean_ms


def read(run):
    return span_mean_ms(run, "trial.carry")
