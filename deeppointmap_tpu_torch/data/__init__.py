"""Device preprocessing, host voxel downsampling and synthetic scans."""
