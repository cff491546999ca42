"""Traffic: a mix's parameters (``<mix>.json``) and the laws that make its
frames from a seed (``<law>.py``, named by the mix's ``law``)."""
