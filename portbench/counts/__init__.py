"""The benchmark's frozen counts: the card's peaks, the operations and bytes
each kernel's algorithm needs, and a training step's model FLOPs.

They are the yardstick of the roofline shares and of the step's MFU, so
they live here, beside the benchmark, and not in the program: a change to
the program cannot move them.  Each function takes plain numbers (the
configuration file's sizes and the traffic's batch and sequence) and
imports nothing of the program.
"""
