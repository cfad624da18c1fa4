"""``certify.mfu`` in the PGGAN configuration's certify cell: it moves the
cell's ``certify_samples_per_s``. It counts model FLOPs, as
the reference computes them: each up layer a 3x3 convolution at the
upsampled resolution (98.10 GFLOP a sample in all, 85.47 of them the
synthesis). The program runs each up layer as a transposed convolution of
2x2 taps an output, about 30 GFLOP a sample fewer, and
``pggan_high_roofline`` counts those executed taps (the generator family's
``high_work``)."""

from cfr_bench import harness

read = harness.load_module(
    harness.HERE / "metrics" / "certify.mfu.py").read
