"""FedPFT core: GMMs, the classifier head, and the one-shot round."""
