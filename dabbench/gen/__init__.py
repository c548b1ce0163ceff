"""The benchmark's traffic generator: a frozen copy of the port's numpy
transmitter and the payload generators it is fed with.

The subpackages are copies of ``dabjax_torch``'s modules at the same
relative paths (the modulator ``tx/``, the FIG encoder, the MP2 and
HE-AAC fixture encoders and the numpy modules they import), with their
imports rewritten to this package, so that a later change to the port
cannot move the yardstick.  ``fic_layout`` holds the two FIC layout
functions the modulator needs, copied out of the port's torch FIC
decoder.  :mod:`dabbench.gen.loop` is the benchmark's own: it turns a
configuration file and a seed into a seamless loop of u8 IQ.
"""
