"""One judge a kernel, found by the kernel's name: ``reference`` works the
sampled answers out again with the plain reference, ``compare`` gives the
numbers held to ``LIMITS``."""
