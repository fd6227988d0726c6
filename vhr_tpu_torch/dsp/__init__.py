"""Signal processing: spectral BPM estimation and dropout filling."""
