"""The inference engine and the SLAM host layer around it."""
