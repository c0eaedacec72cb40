from deepvcp.train.cli import main

main()
