"""Topic models: layers, networks, losses, share masks and the AVITM facade."""
