"""lane_mcus: the serial depth of one decode lane, in MCUs: the MCUs that
the program's ``Decoder.decode_rows`` launched over the lanes it launched
(its counters ``mcus_launched`` and ``lanes_launched``, added once a call),
over the run. One lane a restart segment: 1 with a restart every MCU, the
frame's MCUs with none."""

from perfbench.harness.counters import count, ratio


def read(ctx):
    return ratio(count("mcus_launched"), count("lanes_launched"))
