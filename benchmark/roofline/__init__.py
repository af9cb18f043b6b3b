"""The yardstick of the roofline metrics: the card's peaks with their
sources (``peaks.py``) and the operations, bytes and FLOPs each measured
kernel and the learner's step need (``counts.py``), frozen here so that
no change to the program can change them."""
