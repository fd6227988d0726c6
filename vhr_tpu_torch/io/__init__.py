"""Video I/O: cv2 decode and encode, and the read-ahead chunk reader."""
