"""Signal-processing helpers of the port."""
