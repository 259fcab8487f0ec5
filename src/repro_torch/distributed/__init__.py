"""Distribution helpers of the port (one GPU so far)."""
