@echo off
rem Launcher for the PyTorch/CUDA port's CLI (softspoken_tpu_torch), the Windows
rem counterpart of scripts/softspoken_torch.
setlocal
set REPO_DIR=%~dp0..
set PYTHONPATH=%REPO_DIR%;%PYTHONPATH%
python -m softspoken_tpu_torch %*
endlocal
