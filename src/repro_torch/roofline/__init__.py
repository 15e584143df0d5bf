from repro_torch.roofline.analysis import HW, analyze_cell

__all__ = ["analyze_cell", "HW"]
