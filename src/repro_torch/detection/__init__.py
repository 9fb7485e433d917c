"""Moving-object detection (paper §IV-C): the pixel cascade's mask ->
connected components -> filtered boxes -> crops."""
