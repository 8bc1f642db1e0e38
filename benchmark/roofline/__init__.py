"""The yardstick of the roofline metrics: the card's peaks and the work of
a LiDAR frame, frozen with the benchmark."""
