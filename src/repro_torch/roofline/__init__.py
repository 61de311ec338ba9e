"""The roofline of the port: the H100's peaks and bounds (``model``), the
count of a step on meta tensors (``dispatch_count``), and the card's
kernels by region (``attribution``)."""
