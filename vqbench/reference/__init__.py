"""The benchmark's plain reference of the paper's schemes (``vq_plain``)."""
